"""Fused per-batch programs: wire reconstruction traced inline into the
order kernel (one XLA program per batch), plus the deferred dynamic-normal
min-count guard.

Split out of analysis.py (round 5)."""

from __future__ import annotations

import numpy as np

from .wire import (
    _b7_impl,
    _d8_ints_impl,
    _s6_ints_impl,
    _unpack12_impl,
)

def _pop_normal_guard(result) -> None:
    """Validate the fused dynamic-normal min-count guard (the ≥3-points
    check of NormalsRuntime.normals_for_batch, deferred to result-drain
    time; wording: src/errors.rs:173-176)."""
    guard = result.pop("_normal_guard", None)
    if guard is None:
        return
    got = float(np.asarray(guard))
    if got < 3:
        from ..errors import DynamicNormalError

        raise DynamicNormalError(
            f"not enough points for dynamic local membrane normal "
            f"calculation: got '{int(got)}', need at least '3' points \n"
            f"(hint: try increasing the 'radius' in the "
            f"'membrane_normal' section of your input configuration "
            f"file)")
def _build_fused_steps(step, *, n_out, classify_impl=None,
                       normals_impl=None, channel_classify=None,
                       channel_coords_classify=None, aux_classify=None,
                       aux_normals=None, n_bonds=None,
                       collect_classes=False, collect_normals=False):
    """Fused per-batch programs: wire reconstruction traced inline into
    the order kernel, so XLA compiles ONE program per batch.

    Dispatching the wire decoder (_s6_to_f32 / _d8_to_f32 / _unpack12)
    and the order step as two top-level jits would force XLA to
    materialize the (B, A, 3) f32 coordinates between them; one program
    lets the reconstruction fuse into its consumers.

    With classify_impl (LeafletRuntime.fused_classify_impl: every-frame
    global/local/individual leaflet classification), the classes are
    computed inside the same program and consumed directly by the
    kernel's upper/lower reductions — they never leave the device (the
    two-dispatch path fetches the (B, M) classes to the host and ships
    them back: two host round-trips per batch).

    Returns get(kind) -> jitted fn(wire_devs, scale, box, normal, mask,
    map_state, geom_ref) -> (result, map_out), built lazily per payload
    kind (a mid-run wire fallback switches kinds, e.g. s6 -> i16), or
    None when `step` exposes no traceable impl.
    """
    impl = getattr(step, "impl", None)
    if impl is None:
        return None
    import jax
    import jax.numpy as jnp

    def geo_bits(geo_u8, n_bonds):
        """(B, stride) u8 decoder bitplane → (B, n_bonds) f32 mask (bit j
        of byte j>>3 = bond j inside the shape; io/traj.py
        read_geo_mask)."""
        shifts = jnp.arange(8, dtype=jnp.uint8)
        bits = (geo_u8[:, :, None] >> shifts[None, None, :]) & jnp.uint8(1)
        return bits.reshape(geo_u8.shape[0], -1)[:, :n_bonds] \
            .astype(jnp.float32)

    def run(coords, box, normal, mask, map_state, geom_ref, inv_scale=None,
            cog=None, geom_plane=None):
        """Shared tail: optional in-program classification / dynamic
        normals + the kernel. When either consumer is present,
        coordinates are dequantized once up front (the multiply is fused
        either way; traces identically to inv_scale). With `cog` (the
        decoder-COG channel class riding a coordinate wire),
        classification compares against the decoder's per-frame
        Bai-Breen center — the same number the b7g side channel ships —
        so output is bitwise identical across wire formats."""
        classes = guard = None
        cf = coords
        if (classify_impl is not None or normals_impl is not None
                or cog is not None) and inv_scale is not None:
            # f32 view for the coordinate consumers; the kernel keeps the
            # INTEGER coords + inv_scale so its bond vectors take the
            # single-rounding integer-difference path (core/order.py) —
            # XLA fuses the dequantization into each consumer
            cf = coords.astype(jnp.float32) * inv_scale[:, None, None]
        if cog is not None:
            classes = channel_coords_classify(cf, cog, box)
        elif classify_impl is not None:
            classes = classify_impl(cf, box)
        if normals_impl is not None:
            normal, counts = normals_impl(cf, box)
            # min cloud size over the valid frames — the ≥3-points
            # validation, checked host-side when the result drains
            guard = jnp.min(jnp.where(mask[:, None], counts,
                                      jnp.float32(1e9)))
        result, map_out = impl(
            coords, box, normal, mask, leaflet_classes=classes,
            inv_scale=inv_scale, map_state=map_state,
            geom_ref=geom_ref, geom_plane=geom_plane)
        if guard is not None or (collect_classes and classes is not None) \
                or collect_normals:
            result = dict(result)
        if guard is not None:
            result["_normal_guard"] = guard
        # collection (export) runs: the in-program classes / normals are
        # returned as extra outputs and drained host-side, so export runs
        # keep the compact fused wires (the drained values are exactly
        # what the kernel consumed)
        if collect_classes and classes is not None:
            result["_classes"] = classes
        if collect_normals and normals_impl is not None:
            result["_normals"] = normal
        return result, map_out

    def build(kind):
        if kind == "b7":
            assert classify_impl is None, \
                "b7 is gated to pure bond-order runs"

            def fused(w, scale, box, normal, mask, map_state, geom_ref):
                pk, eg, ev, base = w
                dq = _b7_impl(pk, eg, ev, base)
                return impl(dq, box, normal, mask, inv_scale=scale,
                            map_state=None, geom_ref=None, diff_input=True)
        elif kind == "b7x":
            # b7 wire + aux atom side channel: every coordinate consumer
            # of this run (individual leaflet classification, dynamic
            # normals) needs only a small atom set, which the decoder
            # ships as exact int32 positions (native/xdr.cpp
            # emit_channels) — dequantized f32(int)·inv_precision, the
            # gathered values are bit-identical to a full-coordinate
            # reconstruction, so output matches the coordinate wires
            # byte-for-byte. Reference: leaflets.rs Individual,
            # normal.rs:179-199 (heads cloud).
            assert aux_classify is not None or aux_normals is not None

            def fused(w, scale, box, normal, mask, map_state, geom_ref):
                pk, eg, ev, base, aux = w
                dq = _b7_impl(pk, eg, ev, base)
                aux_f = aux.astype(jnp.float32) * scale[:, None, None]
                classes = guard = None
                if aux_classify is not None:
                    classes = aux_classify(aux_f, box)
                if aux_normals is not None:
                    normal, counts = aux_normals(aux_f, box)
                    guard = jnp.min(jnp.where(mask[:, None], counts,
                                              jnp.float32(1e9)))
                result, map_out = impl(
                    dq, box, normal, mask, leaflet_classes=classes,
                    inv_scale=scale, map_state=None, geom_ref=None,
                    diff_input=True)
                if guard is not None or collect_classes or collect_normals:
                    result = dict(result)
                if guard is not None:
                    result["_normal_guard"] = guard
                if collect_classes and classes is not None:
                    result["_classes"] = classes
                if collect_normals and aux_normals is not None:
                    result["_normals"] = normal
                return result, map_out
        elif kind == "b7geo":
            # b7 wire + decoder geometry mask bitplane: the decoder
            # evaluates the shape's midpoint inside-test host-side
            # (native/xdr.cpp xtc_geo_mask) and ships 1 bit/bond, so
            # geometry-restricted runs become bond-vector-wire eligible.
            # Coordinate wires consume the same bitplane (kinds *G), so
            # geometry output is bitwise identical across wire formats.
            def fused(w, scale, box, normal, mask, map_state, geom_ref):
                pk, eg, ev, base, geo = w
                dq = _b7_impl(pk, eg, ev, base)
                plane = geo_bits(geo, dq.shape[1])
                return impl(dq, box, normal, mask, inv_scale=scale,
                            map_state=None, geom_ref=None,
                            geom_plane=plane, diff_input=True)
        elif kind == "b7m":
            # b7 wire + host-computed (B, M) leaflet class plane: manual
            # tables and frequency-gated classification methods never need
            # device coordinates on non-assignment frames (reference
            # src/analysis/leaflets.rs manual variants + Frequency,
            # src/input/frequency.rs:13-55), so the run ships bond vectors
            # plus ~4·M bytes/frame of classes instead of coordinates
            def fused(w, scale, box, normal, mask, map_state, geom_ref):
                pk, eg, ev, base, classes = w
                dq = _b7_impl(pk, eg, ev, base)
                return impl(dq, box, normal, mask, leaflet_classes=classes,
                            inv_scale=scale, map_state=None, geom_ref=None,
                            diff_input=True)
        elif kind == "b7g":
            assert channel_classify is not None, \
                "b7g requires a leaflet channel classifier"

            def fused(w, scale, box, normal, mask, map_state, geom_ref):
                pk, eg, ev, base, aux, cog = w
                dq = _b7_impl(pk, eg, ev, base)
                # heads dequantize exactly like the coordinate wires:
                # f32(int) * inv_precision — bit-identical gather
                heads = aux.astype(jnp.float32) * scale[:, None, None]
                classes = channel_classify(heads, cog, box)
                result, map_out = impl(
                    dq, box, normal, mask, leaflet_classes=classes,
                    inv_scale=scale, map_state=None, geom_ref=None,
                    diff_input=True)
                if collect_classes:
                    result = dict(result)
                    result["_classes"] = classes
                return result, map_out
        else:
            # coordinate wires, with or without the decoder-COG channel:
            # kinds 's6g'/'d8g'/'i12g'/'i16g'/'f32g' carry a trailing
            # per-frame (B,) f32 COG the channel classifier consumes;
            # kinds 's6G'/... carry a trailing (B, stride) u8 decoder
            # geometry bitplane instead (geometry channel class)
            geo_chan = kind.endswith("G")
            chan = kind.endswith("g")
            base_kind = kind[:-1] if (chan or geo_chan) else kind
            if chan:
                assert channel_coords_classify is not None, \
                    f"{kind} requires a leaflet channel classifier"

            def recon(w, scale):
                """(coords-or-quant, inv_scale) for the base wire kind —
                integer wires stay INTEGER here so the kernel's quantized
                path takes exact integer bond differences (single
                rounding, bit-identical to b7)."""
                if base_kind == "s6":
                    pk, eg, ev, bs, gm, vg = w
                    return _s6_ints_impl(pk, eg, ev, bs, gm, vg), scale
                if base_kind == "d8":
                    lo, ci, ch, abs0 = w
                    return _d8_ints_impl(lo, ci, ch, abs0), scale
                if base_kind == "i12":
                    (packed,) = w
                    return _unpack12_impl(packed, n_out), scale
                if base_kind == "i16":
                    (quant,) = w
                    return quant, scale
                (coords,) = w                                # f32
                return coords, None

            def fused(w, scale, box, normal, mask, map_state, geom_ref):
                cog = plane = None
                if chan:
                    *w, cog = w
                elif geo_chan:
                    *w, geo = w
                coords, inv = recon(w, scale)
                if geo_chan:
                    plane = geo_bits(geo, n_bonds)
                return run(coords, box, normal, mask, map_state,
                           None if geo_chan else geom_ref,
                           inv_scale=inv, cog=cog, geom_plane=plane)
        return jax.jit(fused)

    cache = {}

    def get(kind):
        if kind not in cache:
            cache[kind] = build(kind)
        return cache[kind]

    return get
