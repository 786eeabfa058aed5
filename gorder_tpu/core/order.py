"""The P2/order-parameter device kernel.

The reference's innermost hot loop (BondType::analyze_frame,
src/analysis/topology/bond.rs:396-446: per bond instance → min-image vector →
normal projection → `calc_sch` = 1.5·cos²θ − 0.5 → fixed-point accumulate)
re-architected for batched accelerator execution:

- all bond instances of all molecule types form one flat index array;
- a frame *batch* (B, A, 3) is processed by pure vectorized ops: gather both
  endpoints, min-image, P2 against the membrane normal, then per-frame
  per-bond-type reduction expressed as one einsum against a one-hot
  (N × T) membership matrix — a single matrix product instead of 10⁴
  scattered accumulator updates;
- reference parity: each sample is quantized to 1e-6 fixed point exactly like
  the reference's `OrderValue` (src/analysis/order.rs:21-26: `(v as f64 *
  1e6).round()` — round half away from zero), reproduced bit-for-bit in
  pure f32 via an error-free two-product (see quantize_split), so no f64
  arithmetic is needed on the device. The quantized integers are
  split into three 7-bit limbs so the reduction runs as exact matrix
  products (each limb < 128, so per-frame per-type sums stay below 2^24
  for up to MAX_EXACT_SAMPLES = 131,072 bond instances per type);
  limbs are recombined into int64 on the host. Results are then invariant
  to batch size, device count and frame order — the analogue of the
  reference's thread-count invariance (SURVEY.md §4 tier 3).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..parallel.context import put_const

from .pbc import min_image

_SCALE = 1.0e6
_LIMB = 128.0            # 7-bit limbs → exact f32 dot products
_LIMB2 = _LIMB * _LIMB   # 16384
# exactness ceiling: limbs < 128 summed in f32 stay integer-exact below
# 2^24 → at most 2^24/128 samples per bond type per frame
MAX_EXACT_SAMPLES = int(2 ** 24 / _LIMB)


_BH = 999424.0   # 15616·2^6: high split of 1e6, ≤12 significant bits
_BL = 576.0      # 9·2^6: 1e6 − _BH, exact


def _twoprod_err(a, ab):
    """Error term of the f32 product a·1e6: a·1e6 = ab + err exactly.

    Two details are load-bearing under XLA's algebraic simplifier: the
    Veltkamp split masks mantissa bits instead of using the arithmetic
    `c − (c − a)` form, which a simplifier may fold away; and the
    correction terms are summed in Dekker's sequential order —
    regrouping them loses exactness."""
    ah = jax.lax.bitcast_convert_type(
        jax.lax.bitcast_convert_type(a, jnp.uint32)
        & jnp.uint32(0xFFFFF000), jnp.float32)
    al = a - ah
    return (((ah * _BH - ab) + ah * _BL) + al * _BH) + al * _BL


def quantize_split(sch):
    """Reference-exact per-sample quantization (order.rs:21-26: the f64
    product `v as f64 * 1e6`, round half away from zero) split into three
    small-integer f32 limbs: q = l2·16384 + l1·128 + l0, each |limb| < 128.

    The f64 product of an f32 value by 1e6 is exact (≤44 significant
    bits), so reproducing it in f32 needs only the error-free two-product:
    x + err == v·1e6 exactly; floor(x) plus a half-away test on the exact
    residual then matches the reference's rounding bit for bit, with no
    f64 arithmetic on the device."""
    x = sch * _SCALE
    err = _twoprod_err(sch, x)
    r = jnp.floor(x)
    # exact residual vs the .5 boundary: x−r and the −0.5 subtraction are
    # exact near the boundary (Sterbenz), and g+err cancels exactly when
    # small, so the comparison reproduces the f64 rounding bit for bit
    g = (x - r) - 0.5
    s = g + err
    q = r + ((s > 0) | ((s == 0) & (x > 0))).astype(x.dtype)
    l2 = jnp.trunc(q / _LIMB2)
    rem = q - l2 * _LIMB2
    l1 = jnp.trunc(rem / _LIMB)
    l0 = rem - l1 * _LIMB
    return l2, l1, l0


def recombine_limbs(rows: np.ndarray) -> np.ndarray:
    """(…, 4, T) f32 kernel output rows [l2, l1, l0, count] → int64
    (sums, counts)."""
    rows = np.asarray(rows, np.float64)
    sums = (rows[..., 0, :] * _LIMB2 + rows[..., 1, :] * _LIMB
            + rows[..., 2, :]).astype(np.int64)
    counts = rows[..., 3, :].astype(np.int64)
    return sums, counts


def limb_reduce(l2, l1, l0, mask, onehot):
    """(B, N) limbs and sample mask → (B, 4, T) per-type sums
    [l2, l1, l0, count] of one frame batch.

    Exact in bf16: every operand is a small integer — limbs are |v| < 128
    (7 bits) and masks are {0, 1} — so the cast to bf16 (8-bit mantissa:
    integers ≤ 256 exact), the bf16×bf16 products, and the f32
    accumulation of integer values below 2^24 (MAX_EXACT_SAMPLES samples
    per type) are all error-free, and the product runs at the bf16
    matrix rate."""
    stacked = jnp.stack(
        [l2 * mask, l1 * mask, l0 * mask, mask],
        axis=1).astype(jnp.bfloat16)                  # (B, 4, N)
    return jnp.einsum(
        "bcn,nt->bct", stacked, onehot.astype(jnp.bfloat16),
        preferred_element_type=jnp.float32,
    )


def _one_hot(ids: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((len(ids), n), np.float32)
    out[np.arange(len(ids)), ids] = 1.0
    return out


def _geometry_reference(coords, box_diag, geom_ref, handle_pbc):
    """Resolve the geometry reference point per frame.

    geom_ref is either a (B, 3) array (fixed point / box center, computed on
    the host) or a (K,) int32 index array — the per-frame center of geometry
    of a selection, recomputed every frame like the reference
    (geometry.rs init_reference)."""
    from .pbc import circular_mean_cog, naive_cog

    if geom_ref.ndim == 2:
        return geom_ref
    pts = jnp.take(coords, geom_ref, axis=1)          # (B, K, 3)
    mask = jnp.ones(pts.shape[:-1], coords.dtype)
    if handle_pbc:
        return circular_mean_cog(pts, mask, box_diag)
    return naive_cog(pts, mask)


def _order_step_impl(coords, box_diag, normal, frame_mask, atom_a, atom_b,
                     bond_mol, onehot, leaflet_classes, inv_scale=None,
                     bond_type_ids=None, map_state=None, geom_ref=None,
                     geom_plane=None, *,
                     handle_pbc, with_leaflets, normal_mode, quantized=False,
                     map_spec=None, geom_spec=None, diff_input=False):
    from .geometry import inside_mask
    from .ordermap import map_cells, update_maps

    if diff_input:
        # `coords` is already the (B, N, 3) bond-vector array (b7 wire:
        # exact integer differences dequantized on device) — positions
        # never materialize, so midpoints are unavailable
        assert map_spec is None and geom_spec is None
        if quantized:
            coords = coords.astype(jnp.float32) * inv_scale[:, None, None]
        pa = None
        d = coords
    elif quantized and map_spec is None:
        # Integer wire (s6/d8/i12/i16 XTC integers): subtract FIRST, in
        # exact integer arithmetic, then dequantize — the single-rounding
        # bond vector d = f32(q_b − q_a)·s, bit-identical to the b7
        # wire's formulation, so every integer wire yields
        # bitwise-identical output, and so do cross-configuration
        # invariants like "geometry z≥0 equals the upper leaflet"
        # (tests/test_geometry.py) — the position-pair difference of two
        # rounded products differs at the last ulp and survives only on
        # the f32 wire (TRR/GRO input or mixed-precision XTC, where no
        # integers exist). ORDERMAP configurations instead keep the PAIR
        # formulation below, matching the reference's f32-position
        # arithmetic exactly: re-encoded fixtures quantize coordinates
        # onto grids whose bond midpoints sit exactly on map-bin
        # boundaries, where a last-ulp change reassigns samples
        # wholesale — and b7 is ineligible there anyway, so every wire
        # a map run can ride agrees bitwise either way. (Geometry shape
        # boundaries are COG-anchored, not grid-aligned, so geometry
        # runs stay on the single-rounding path.)
        scale3 = inv_scale[:, None, None]
        pa_i = jnp.take(coords, atom_a, axis=1).astype(jnp.int32)
        pb_i = jnp.take(coords, atom_b, axis=1).astype(jnp.int32)
        d = (pb_i - pa_i).astype(jnp.float32) * scale3
        pa = None
        if geom_spec is not None and geom_plane is None:
            # geometry needs positions: same f32(int)·s rounding as the
            # host decode (bit-identical)
            pa = pa_i.astype(jnp.float32) * scale3
            coords = coords.astype(jnp.float32) * scale3
    else:
        if quantized:
            coords = coords.astype(jnp.float32) * inv_scale[:, None, None]
        pa = jnp.take(coords, atom_a, axis=1)        # (B, N, 3)
        pb = jnp.take(coords, atom_b, axis=1)
        d = pb - pa
    if handle_pbc:
        d = min_image(d, box_diag[:, None, :])

    if normal_mode == "static":
        proj = jnp.einsum("bnc,c->bn", d, normal)
        n2 = jnp.float32(1.0)
    else:
        per_bond_normal = jnp.take(normal, bond_mol, axis=1)  # (B, N, 3)
        proj = jnp.sum(d * per_bond_normal, axis=-1)
        n2 = jnp.maximum(
            jnp.sum(per_bond_normal * per_bond_normal, axis=-1), 1e-18)

    d2 = jnp.sum(d * d, axis=-1)
    cos2 = (proj * proj) / (jnp.maximum(d2, 1e-18) * n2)
    sch = 1.5 * cos2 - 0.5                            # (B, N)

    # reference-exact per-sample fixed-point quantization
    l2, l1, l0 = quantize_split(sch)

    valid = frame_mask[:, None].astype(jnp.float32)   # (B, 1)
    ones = jnp.broadcast_to(valid, sch.shape)

    mid = None
    if map_spec is not None or (geom_spec is not None
                                and geom_plane is None):
        mid = pa + d * 0.5                            # min-image bond midpoint
    if geom_plane is not None:
        # decoder-evaluated inside mask (io/traj.py read_geo_mask): the
        # channel class consumes ONE mask on every wire, so geometry
        # output is bitwise identical across wire formats — and the b7
        # bond-vector wire (no positions) becomes geometry-eligible
        ones = ones * geom_plane
    elif geom_spec is not None:
        ref = _geometry_reference(coords, box_diag, geom_ref, handle_pbc)
        geo = inside_mask(mid, ref, box_diag, geom_spec, handle_pbc)
        ones = ones * geo

    masks = {"total": ones}
    if with_leaflets:
        cls = jnp.take(leaflet_classes, bond_mol, axis=1)  # (B, N)
        masks["upper"] = ones * (cls == 0)
        masks["lower"] = ones * (cls == 1)

    out = {c: limb_reduce(l2, l1, l0, m, onehot) for c, m in masks.items()}

    if map_spec is not None:
        n_types = onehot.shape[1]
        cells, _ = map_cells(mid, map_spec, bond_type_ids, n_types)
        map_state = update_maps(map_state, sch, cells, masks)
    return out, map_state


# jitted wrapper for direct per-batch use; the fused per-batch programs
# (engine/fused.py _build_fused_steps) trace _order_step_impl inline instead —
# a nested-jit boundary blocks XLA fusion with the wire reconstruction
_order_step = jax.jit(
    _order_step_impl,
    static_argnames=("handle_pbc", "with_leaflets", "normal_mode",
                     "quantized", "map_spec", "geom_spec", "diff_input"),
)


def make_order_step(
    atom_a: np.ndarray,
    atom_b: np.ndarray,
    bond_type: np.ndarray,
    bond_mol: np.ndarray,
    n_types: int,
    n_molecules: int,
    *,
    handle_pbc: bool = True,
    with_leaflets: bool = False,
    normal_mode: str = "static",     # 'static' | 'per_molecule'
    map_spec=None,
    geom_spec=None,
):
    """Build the per-batch order kernel (index arrays are device-resident
    arguments, not baked-in constants — keeps XLA compile time low and lets
    one compiled program serve any analysis of the same shape).

    Returns step(coords, box_diag, normal, frame_mask, leaflet_classes)
      coords:          (B, A, 3) f32
      box_diag:        (B, 3) f32 (ignored when handle_pbc=False)
      normal:          (3,) f32 for 'static', (B, M, 3) for 'per_molecule'
      frame_mask:      (B,) bool — padding frames contribute nothing
      leaflet_classes: (B, M) int32 (0=upper, 1=lower) or None
    and yielding a dict of (B, 4, T) f32 arrays per class
    ([l2, l1, l0, count]; sum = l2·16384 + l1·128 + l0 exactly,
    ×1e-6 → order).
    """
    atom_a_d = put_const(np.asarray(atom_a, np.int32))
    atom_b_d = put_const(np.asarray(atom_b, np.int32))
    bond_mol_d = put_const(np.asarray(bond_mol, np.int32))
    bond_type_d = put_const(np.asarray(bond_type, np.int32))
    onehot_d = put_const(_one_hot(np.asarray(bond_type), n_types))
    dummy_classes = put_const(np.zeros((1, 1), np.int32))

    def step(coords, box_diag, normal, frame_mask, leaflet_classes=None,
             inv_scale=None, map_state=None, geom_ref=None):
        return _order_step(
            coords, box_diag, normal, frame_mask,
            atom_a_d, atom_b_d, bond_mol_d, onehot_d,
            leaflet_classes if leaflet_classes is not None else dummy_classes,
            inv_scale, bond_type_d, map_state, geom_ref,
            handle_pbc=handle_pbc, with_leaflets=with_leaflets,
            normal_mode=normal_mode, quantized=inv_scale is not None,
            map_spec=map_spec, geom_spec=geom_spec,
        )

    def step_impl(coords, box_diag, normal, frame_mask, leaflet_classes=None,
                  inv_scale=None, map_state=None, geom_ref=None,
                  geom_plane=None, *, diff_input=False):
        """Traceable (unjitted) step body for fused per-batch programs
        (engine/fused.py _build_fused_steps): the wire reconstruction and
        the order kernel trace into ONE XLA program — a nested-jit boundary
        between them forces materialization of the (B, A, 3) coordinates.
        With diff_input=True, `coords` is the (B, N, 3) bond-vector array
        (b7 wire; no map/geom — b7 eligibility excludes them)."""
        if diff_input:
            assert map_state is None and geom_ref is None
        return _order_step_impl(
            coords, box_diag, normal, frame_mask,
            atom_a_d, atom_b_d, bond_mol_d, onehot_d,
            leaflet_classes if leaflet_classes is not None else dummy_classes,
            inv_scale, bond_type_d, map_state, geom_ref, geom_plane,
            handle_pbc=handle_pbc, with_leaflets=with_leaflets,
            normal_mode=normal_mode, quantized=inv_scale is not None,
            map_spec=None if diff_input else map_spec,
            geom_spec=None if diff_input else geom_spec,
            diff_input=diff_input,
        )

    step.impl = step_impl
    return step


class OrderAccumulator:
    """Host-side exact accumulation of per-frame kernel outputs.

    Keeps int64 running sums/counts per bond type and (optionally) the
    per-frame time series needed for error estimation and convergence
    (the reference's TimeWiseData, src/analysis/timewise.rs)."""

    def __init__(self, n_types: int, classes=("total",), keep_timewise=False):
        self.n_types = n_types
        self.classes = classes
        self.keep_timewise = keep_timewise
        self.sums = {c: np.zeros(n_types, np.int64) for c in classes}
        self.counts = {c: np.zeros(n_types, np.int64) for c in classes}
        self.timewise_sums = {c: [] for c in classes} if keep_timewise else None
        self.timewise_counts = {c: [] for c in classes} if keep_timewise else None
        self.n_frames = 0

    def add_batch(self, result: dict, n_valid: int) -> None:
        for c in self.classes:
            res = np.asarray(result[c][:n_valid])              # (b, 4, T)
            frame_sums, frame_counts = recombine_limbs(res)
            self.sums[c] += frame_sums.sum(axis=0)
            self.counts[c] += frame_counts.sum(axis=0)
            if self.keep_timewise:
                self.timewise_sums[c].append(frame_sums)
                self.timewise_counts[c].append(frame_counts)
        self.n_frames += n_valid

    def timewise(self, cls: str):
        """(frames, T) int64 per-frame sums and counts."""
        if not self.keep_timewise:
            raise ValueError("timewise data was not collected")
        return (
            np.concatenate(self.timewise_sums[cls], axis=0),
            np.concatenate(self.timewise_counts[cls], axis=0),
        )

    def order_values(self, cls: str, min_samples: int = 1) -> np.ndarray:
        """Average order per bond type; NaN below min_samples
        (order.rs `calc_order`)."""
        sums = self.sums[cls]
        counts = self.counts[cls]
        with np.errstate(invalid="ignore", divide="ignore"):
            values = sums / _SCALE / counts
        return np.where(counts >= max(min_samples, 1), values, np.nan)
