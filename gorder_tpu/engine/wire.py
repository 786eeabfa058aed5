"""Wire formats: device-side decoders for the compact exact coordinate /
bond-vector transfer formats (b7 / s6 / d8 / i12 / i16 / f32), the
per-format eligibility probes, and the rate-aware format selection.

Split out of analysis.py (round 5); format layouts live in io/native.py
and native/xdr.cpp (encoders); every format is exact, so selection never
changes results (tests/test_io_traj.py)."""

from __future__ import annotations

import functools as _functools
import logging
import os

import numpy as np

from ..io.traj import AtomSubset
from ..system import System

log = logging.getLogger("gorder")

def _unpack12_impl(p, n):
    """Plain (unjitted) i12 unpack — traceable inline inside a fused
    per-batch program (a nested-jit boundary would block XLA fusion and
    force canonical-layout materialization: measured 6x slower)."""
    import jax.numpy as jnp

    b0 = p[:, 0::3].astype(jnp.int32)
    b1 = p[:, 1::3].astype(jnp.int32)
    b2 = p[:, 2::3].astype(jnp.int32)
    v0 = (b0 | ((b1 & 0xF) << 8))
    v1 = ((b1 >> 4) | (b2 << 4))
    v0 = (v0 ^ 0x800) - 0x800   # sign-extend 12 -> 32 bits
    v1 = (v1 ^ 0x800) - 0x800
    vals = jnp.stack([v0, v1], axis=-1).reshape(p.shape[0], -1)
    return vals[:, :n * 3].reshape(p.shape[0], n, 3).astype(jnp.int16)


def _d8_ints_impl(lo, ci, ch, a0):
    """Temporal-delta wire → (B, n, 3) int32 absolute XTC integers."""
    import jax.numpy as jnp

    b, n, _ = lo.shape
    nv = n * 3
    delta = lo.astype(jnp.int32).reshape(b, nv)
    corr = jnp.zeros((b, nv + 1), jnp.int32)
    corr = corr.at[jnp.arange(b)[:, None], ci].add(
        ch.astype(jnp.int32) << 8, mode="drop")
    delta = delta + corr[:, :nv]
    absr = a0.reshape(1, nv).astype(jnp.int32) + jnp.cumsum(delta, axis=0)
    return absr.reshape(b, n, 3)


def _d8_impl(lo, ci, ch, a0, ip):
    import jax.numpy as jnp

    return _d8_ints_impl(lo, ci, ch, a0).astype(jnp.float32) \
        * ip[:, None, None]


def _s6_ints_impl(pk, gp, vl, bs, gm, vg):
    """Smoothed-base 6-bit wire → (B, n, 3) int32 absolute XTC integers."""
    import jax.numpy as jnp

    b = pk.shape[0]
    trip = pk.reshape(b, -1, 3).astype(jnp.uint32)
    u = trip[..., 0] | (trip[..., 1] << 8) | (trip[..., 2] << 16)
    codes = jnp.stack([u & 63, (u >> 6) & 63, (u >> 12) & 63,
                       (u >> 18) & 63], axis=-1).reshape(b, -1)
    codes = ((codes.astype(jnp.int32) + 32) & 63) - 32  # sign-extend
    nv = vg.shape[0]
    r = codes[:, :nv]
    pos = jnp.cumsum(gp.astype(jnp.int32), axis=1) - 1
    pos = jnp.where(gp == 0, nv, pos)       # gap 0 = padding -> dropped
    r = r.at[jnp.arange(b)[:, None], pos].set(vl.astype(jnp.int32),
                                              mode="drop")
    gmv = jnp.take(gm.astype(jnp.int32), vg, axis=1)
    absr = bs.reshape(1, nv).astype(jnp.int32) + gmv + r
    return absr.reshape(b, nv // 3, 3)


def _s6_impl(pk, gp, vl, bs, gm, vg, ip):
    import jax.numpy as jnp

    return _s6_ints_impl(pk, gp, vl, bs, gm, vg).astype(jnp.float32) \
        * ip[:, None, None]


def _b7_residuals_impl(pk, gp, vl, nv: int):
    """Unpack the b7 wire's escape-applied residuals only: 7-bit codes
    (8 per 7 bytes) sign-extended + the sparse (gap u16, val i16) escape
    channel scattered in → (B, nv) int16 (codes are ±63 and escape values
    i16 by format construction, so int16 is exact); _b7_impl adds the
    per-batch base."""
    import jax.numpy as jnp

    b = pk.shape[0]
    sep = pk.reshape(b, -1, 7).astype(jnp.uint32)
    lo = (sep[..., 0] | (sep[..., 1] << 8) | (sep[..., 2] << 16)
          | (sep[..., 3] << 24))
    hi = sep[..., 4] | (sep[..., 5] << 8) | (sep[..., 6] << 16)
    codes = jnp.stack([
        lo & 127, (lo >> 7) & 127, (lo >> 14) & 127, (lo >> 21) & 127,
        ((lo >> 28) | (hi << 4)) & 127,
        (hi >> 3) & 127, (hi >> 10) & 127, (hi >> 17) & 127,
    ], axis=-1).reshape(b, -1)
    codes = ((codes.astype(jnp.int16) + 64) & 127) - 64  # sign-extend
    r = codes[:, :nv]
    pos = jnp.cumsum(gp.astype(jnp.int32), axis=1) - 1
    pos = jnp.where(gp == 0, nv, pos)       # gap 0 = padding -> dropped
    return r.at[jnp.arange(b)[:, None], pos].set(vl.astype(jnp.int16),
                                                 mode="drop")


def _b7_impl(pk, gp, vl, bs):
    """Unpack the b7 bond-difference wire (io/traj.py read_frames_b7):
    7-bit residual codes (8 per 7 bytes), sparse gap-coded escapes, plus
    the per-batch base → (B, n_bonds, 3) int32 bond integer differences.
    The caller dequantizes (f32(d) · inv_precision) inside the kernel."""
    import jax.numpy as jnp

    nv = bs.shape[0]
    r = _b7_residuals_impl(pk, gp, vl, nv).astype(jnp.int32)
    b = pk.shape[0]
    return (bs.reshape(1, nv).astype(jnp.int32) + r).reshape(b, nv // 3, 3)


def _dequant_impl(q, s):
    import jax.numpy as jnp

    return q.astype(jnp.float32) * s[:, None, None]


@_functools.lru_cache(maxsize=None)
def _device_codecs():
    """Jit the standalone wire decoders ONCE per process.

    These back the leaflets/normals path (which needs f32 coordinates on
    the device before classification); the hot no-classification path
    instead traces the plain *_impl functions inline into one fused
    per-batch program (see _build_fused_steps). Constructing the jitted
    closures per call would re-trace each time (tens of ms of single-core
    Python per batch — the driver shares that core with the decode
    thread)."""
    import jax

    return (jax.jit(_unpack12_impl, static_argnames=("n",)),
            jax.jit(_d8_impl), jax.jit(_s6_impl), jax.jit(_dequant_impl),
            jax.jit(_d8_ints_impl), jax.jit(_s6_ints_impl))


def _unpack12(packed_u8, first_n: int):
    """Device-side unpack of 12-bit packed XTC integers (io/native.py
    i12 layout: two two's-complement values per 3 bytes) → (B, first_n, 3)
    int16, bit-identical to the int16 decode path."""
    return _device_codecs()[0](packed_u8, first_n)


def _d8_to_f32(lo_i8, corr_idx, corr_hi, abs0, inv_prec):
    """Device-side reconstruction of the temporal-delta wire format
    (io/traj.py read_frames_delta8): scatter the sparse high-bit
    corrections, cumulative-sum the deltas over the batch axis on top of
    the absolute base frame, dequantize. Bit-identical to the host f32
    decode for any XTC integer below 2^24 (both sides perform the same
    f32(int) * inv_precision conversion)."""
    return _device_codecs()[1](lo_i8, corr_idx, corr_hi, abs0, inv_prec)


def _s6_to_f32(pack_u8, esc_gap, esc_val, base, gmean, vgidx, inv_prec):
    """Device-side reconstruction of the smoothed-base 6-bit wire format
    (io/traj.py read_frames_s6): unpack the 6-bit residual codes, scatter
    the sparse escape channel (gap-coded positions), add the per-batch
    base and the gathered per-frame per-group medians, dequantize. No
    cross-frame chain (unlike d8's cumsum), so frames are independent.
    Bit-identical to the host f32 decode."""
    return _device_codecs()[2](pack_u8, esc_gap, esc_val, base, gmean,
                               vgidx, inv_prec)


def _d8_to_int(lo_i8, corr_idx, corr_hi, abs0):
    """Device-side d8 reconstruction stopping at the int32 absolute XTC
    integers — the two-dispatch path keeps integers so the order kernel's
    quantized path takes the single-rounding integer-difference bond
    vectors (bit-identical to the b7 wire and the fused programs)."""
    return _device_codecs()[4](lo_i8, corr_idx, corr_hi, abs0)


def _s6_to_int(pack_u8, esc_gap, esc_val, base, gmean, vgidx):
    """Device-side s6 reconstruction stopping at the int32 absolute XTC
    integers (see _d8_to_int)."""
    return _device_codecs()[5](pack_u8, esc_gap, esc_val, base, gmean,
                               vgidx)


def _wire_groups(system: System, space: AtomSubset):
    """Per-slot residue-group ids for the s6 wire format (padding slots =
    -1 → decode to exact zeros) plus the per-value gather indices into the
    (n_groups+1)-wide gmean table (last group is the always-zero padding
    group)."""
    sel = space.sel if space.sel is not None \
        else np.arange(space.first_n, dtype=np.int64)
    res_ids = np.asarray(system.resids)[sel]
    _, ginv = np.unique(res_ids, return_inverse=True)
    group_of = np.full(space.n_out, -1, np.int32)
    group_of[:len(sel)] = ginv.astype(np.int32)
    n_groups = int(ginv.max()) + 1 if len(sel) else 0
    g_rep = np.repeat(group_of, 3)
    k_rep = np.tile(np.arange(3), space.n_out)
    vgidx = np.where(g_rep >= 0, g_rep * 3 + k_rep,
                     n_groups * 3 + k_rep).astype(np.int32)
    return group_of, n_groups, vgidx


def _dequantize(coords_i16, inv_prec):
    """int16 XTC integers → f32 nm, bit-identical to the host conversion."""
    return _device_codecs()[3](coords_i16, inv_prec)
def _probe_s6(traj, frame_indices, space, group_of, n_groups, n_threads,
              batch_size):
    """Probe the s6 wire format over one batch-sized window (escape demand
    grows with distance from the in-batch base window, so short probes
    under-estimate it). Returns a sized esc_cap or None when unfit."""
    from ..io.native import s6_stride

    n = len(frame_indices)
    w = frame_indices[:min(batch_size, n)]
    esc_cap = 512
    for _attempt in range(2):
        pack = np.zeros((len(w), s6_stride(space.n_out)), np.uint8)
        gaps = np.zeros((len(w), esc_cap), np.uint16)
        vals = np.zeros((len(w), esc_cap), np.int16)
        gmean = np.zeros((len(w), (n_groups + 1) * 3), np.int16)
        res, nesc = traj.read_frames_s6(w, space, group_of, n_groups,
                                        pack, gaps, vals, gmean,
                                        n_threads=n_threads)
        if res is not None:
            # headroom for batches the probe did not see (a mid-run
            # overflow falls back to int16 for that batch, so the margin
            # trades certain bytes against a rare 2.4x batch)
            cap = int(nesc * 1.4) + 64
            return max(128, min(8192, (cap + 127) // 128 * 128))
        if nesc <= esc_cap or nesc > 8192:
            return None  # unfit for reasons other than capacity
        esc_cap = min(8192, ((int(nesc * 2) + 127) // 128) * 128)
    return None


def _probe_b7(traj, frame_indices, space, bond_a, bond_b, n_threads,
              batch_size):
    """Probe the b7 bond-difference wire format over one batch-sized
    window. Returns a sized esc_cap or None when unfit."""
    from ..io.native import b7_stride

    n = len(frame_indices)
    w = frame_indices[:min(batch_size, n)]
    esc_cap = 512
    for _attempt in range(2):
        pack = np.zeros((len(w), b7_stride(len(bond_a))), np.uint8)
        gaps = np.zeros((len(w), esc_cap), np.uint16)
        vals = np.zeros((len(w), esc_cap), np.int16)
        res, nesc = traj.read_frames_b7(w, space, bond_a, bond_b,
                                        pack, gaps, vals,
                                        n_threads=n_threads)
        if res is not None:
            cap = int(nesc * 1.4) + 64
            return max(128, min(8192, (cap + 127) // 128 * 128))
        if nesc <= esc_cap or nesc > 8192:
            return None  # unfit for reasons other than capacity
        esc_cap = min(8192, ((int(nesc * 2) + 127) // 128) * 128)
    return None


def _measure_link_mbps(size_mb=6):
    """One-shot host→device transfer rate (MB/s) for wire-format selection.
    Costs a single `size_mb` device_put (~10 ms in good weather, ~1.2 s at
    a 5 MB/s slump) once per run. Returns None when it cannot be measured
    (e.g. the CPU backend, where device_put aliases host memory)."""
    import time as _time

    import jax

    try:
        if jax.default_backend() == "cpu":
            return None
        buf = np.random.default_rng(0).integers(
            0, 255, size=(size_mb << 20,), dtype=np.uint8)
        jax.block_until_ready(jax.device_put(buf[: 1 << 18]))  # warm path
        t0 = _time.perf_counter()
        jax.block_until_ready(jax.device_put(buf))
        return size_mb / (_time.perf_counter() - t0)
    except Exception:  # never let a probe failure kill the run
        return None


# Host-side decode+encode throughput of each wire format relative to the
# plain quantized-int16 decode (measured, tools/decode_bench.py on the
# headline AA system; the ratios are set by the residual-coding work on
# top of the shared 3dfc decode and are stable across systems).
_WIRE_HOST_FACTOR = {"b7": 0.80, "s6": 0.55, "d8": 0.75,
                     "i12": 0.90, "i16": 1.00, "f32": 0.85}


def _probe_d8(traj, windows, space, n_threads):
    """d8 eligibility probe: correction capacity (rounded up, with 2×
    headroom for unseen batches) or None when the windows do not fit."""
    corr_cap = 64
    for _attempt in range(2):
        demand = 0
        ok = True
        for w in windows:
            lo = np.zeros((len(w), space.n_out, 3), np.int8)
            ci = np.zeros((len(w), corr_cap), np.int32)
            ch = np.zeros((len(w), corr_cap), np.int16)
            res, ncorr = traj.read_frames_delta8(w, space, lo, ci, ch,
                                                 n_threads=n_threads)
            demand = max(demand, ncorr)
            if res is None:
                ok = False
        if ok:
            # headroom for batches the probe did not see (box wraps vary)
            corr_cap = max(64, min(4096, int(demand * 2) + 32))
            return ((corr_cap + 63) // 64) * 64
        if demand <= corr_cap or demand > 4096:
            return None  # unfit for reasons other than capacity
        corr_cap = min(4096, ((int(demand * 2) + 63) // 64) * 64)
    return None


def _pick_wire_by_rate(traj, frame_indices, space, n_threads, group_of,
                       n_groups, batch_size, bond_slots, link_mbps):
    """Rate-aware wire selection (see _pick_wire_format): maximize the
    modeled end-to-end rate min(host decode+encode f/s, link bytes/s ÷
    bytes/frame) over the eligible formats. Returns (format, cap) or None
    to defer to the bytes-minimizing policy (non-XTC input)."""
    import time as _time

    from ..io.native import b7_stride, i12_stride, s6_stride

    n = len(frame_indices)
    anchor = frame_indices[:min(16, n)]
    t0 = _time.perf_counter()
    if traj.read_frames_quantized(anchor, space,
                                  n_threads=n_threads) is None:
        return None  # not uniform-precision XTC; bytes policy handles it
    host_i16 = len(anchor) / max(_time.perf_counter() - t0, 1e-9)

    n_out = space.n_out
    candidates = {"i16": (0, n_out * 6), "f32": (0, n_out * 12)}

    def rate(fmt, bpf):
        return min(host_i16 * _WIRE_HOST_FACTOR[fmt],
                   link_mbps * 1024 * 1024 / bpf)

    # fast-link short-circuit: when the link does not bind even for the
    # plain int16 wire, no compact format can model faster (all their
    # host factors are < 1) — skip their probe decodes entirely
    if rate("i16", candidates["i16"][1]) >= host_i16 * 0.999:
        log.info("wire: i16 (link %.0f MB/s does not bind; host decode "
                 "~%.0f frames/s is the wall)", link_mbps, host_i16)
        return "i16", 0

    nv = n_out * 3
    if bond_slots is not None:
        b7_cap = _probe_b7(traj, frame_indices, space, bond_slots[0],
                           bond_slots[1], n_threads, batch_size)
        if b7_cap is not None:
            nb = len(bond_slots[0])
            candidates["b7"] = (b7_cap, b7_stride(nb) + b7_cap * 4
                                + nb * 12 // max(batch_size, 1))
    if group_of is not None and n_groups > 0:
        esc_cap = _probe_s6(traj, frame_indices, space, group_of, n_groups,
                            n_threads, batch_size)
        if esc_cap is not None:
            candidates["s6"] = (esc_cap,
                                s6_stride(n_out) + (n_groups + 1) * 6
                                + esc_cap * 4 + nv * 4 // max(batch_size, 1))
    windows = [frame_indices[:min(8, n)]]
    if n > 16:
        mid = n // 2
        windows.append(frame_indices[mid:mid + 8])
    d8_cap = _probe_d8(traj, windows, space, n_threads)
    if d8_cap is not None:
        candidates["d8"] = (d8_cap, nv + d8_cap * 6)
    probe_idx = frame_indices[np.unique([0, n // 2, n - 1])]
    if traj.read_frames_packed12(probe_idx, space,
                                 n_threads=n_threads) is not None:
        candidates["i12"] = (0, i12_stride(n_out))

    best = max(candidates.items(),
               key=lambda kv: (rate(kv[0], kv[1][1]), -kv[1][1]))
    fmt, (cap, bpf) = best
    log.info("wire: %s (%.1f KB/frame; link %.0f MB/s -> ceiling %.0f "
             "frames/s, modeled host %.0f frames/s)", fmt, bpf / 1024,
             link_mbps, link_mbps * 1024 * 1024 / bpf,
             host_i16 * _WIRE_HOST_FACTOR[fmt])
    return fmt, cap


def _pick_wire_format(traj, frame_indices, space, n_threads, group_of=None,
                      n_groups=0, batch_size=512, bond_slots=None,
                      link_mbps=None):
    """Probe the most compact coordinate transfer the trajectory supports:
    7-bit bond-vector differences (pure bond-order runs only) → 6-bit
    smoothed-base residuals (~0.77 B/atom·axis) → 8-bit temporal
    deltas → 12-bit packed absolutes → int16 → f32. b7/s6/d8 are compared
    by measured bytes/frame. Returns ('b7', esc_cap) / ('s6', esc_cap) /
    ('d8', corr_cap) / ('i12', 0) / ('i16', 0) / ('f32', 0).

    With `link_mbps` (the measured host→device rate), selection maximizes
    the modeled end-to-end rate min(host_rate, link/bytes) instead of
    minimizing bytes alone: on a fast local link the host's residual
    coding becomes the wall before the wire does, and the plain int16
    decode (~1.25× the b7 decode+recode rate) wins even at 3.2× the
    bytes. On a slow link (< ~270 MB/s for the AA benchmark) bytes still
    dominate and the compact formats win as before. Every format is exact,
    so the choice never changes results (tests/test_io_traj.py)."""
    if link_mbps is not None and not os.environ.get("GORDER_TPU_WIRE"):
        picked = _pick_wire_by_rate(traj, frame_indices, space, n_threads,
                                    group_of, n_groups, batch_size,
                                    bond_slots, link_mbps)
        if picked is not None:
            return picked
    n = len(frame_indices)
    windows = [frame_indices[:min(8, n)]]
    if n > 16:
        mid = n // 2
        windows.append(frame_indices[mid:mid + 8])

    forced = os.environ.get("GORDER_TPU_WIRE", "")
    if bond_slots is not None and forced in ("", "b7"):
        b7_cap = _probe_b7(traj, frame_indices, space, bond_slots[0],
                           bond_slots[1], n_threads, batch_size)
        if b7_cap is not None:
            # b7 ships ~0.875 B per bond value vs s6's ~0.75 B per ATOM
            # value; bonds outnumber atoms only in pathological topologies
            # (every heavy atom bonded to >2 analyzed partners), so when
            # eligible and fit, b7 is the smallest wire — no byte
            # comparison needed beyond the stride check below
            from ..io.native import b7_stride, s6_stride

            nb = len(bond_slots[0])
            b7_bytes = b7_stride(nb) + b7_cap * 4 \
                + nb * 12 // max(batch_size, 1)
            s6_bytes_min = s6_stride(space.n_out) + (n_groups + 1) * 6
            if forced == "b7" or b7_bytes < s6_bytes_min:
                return "b7", b7_cap
    if forced == "b7":
        log.warning("GORDER_TPU_WIRE=b7 requested but the run is not "
                    "eligible (non-XTC input, escape overflow, or a "
                    "subsystem needs absolute coordinates); probing the "
                    "coordinate formats instead")
    if forced in ("i12", "i16", "f32"):
        probe_idx = frame_indices[np.unique([0, n // 2, n - 1])]
        if forced == "i12" and traj.read_frames_packed12(
                probe_idx, space, n_threads=n_threads) is not None:
            return "i12", 0
        if forced != "f32" and traj.read_frames_quantized(
                probe_idx, space, n_threads=n_threads) is not None:
            return "i16", 0
        return "f32", 0

    nv = space.n_out * 3
    esc_cap = None
    if group_of is not None and n_groups > 0 and forced in ("", "s6"):
        esc_cap = _probe_s6(traj, frame_indices, space, group_of, n_groups,
                            n_threads, batch_size)
    if forced == "s6":
        if esc_cap is not None:
            return "s6", esc_cap

    d8_cap = None
    if forced in ("", "d8", "s6"):
        d8_cap = _probe_d8(traj, windows, space, n_threads)

    if esc_cap is not None or d8_cap is not None:
        from ..io.native import s6_stride

        s6_bytes = (s6_stride(space.n_out) + (n_groups + 1) * 6
                    + esc_cap * 4 + nv * 4 // max(batch_size, 1)) \
            if esc_cap is not None else None
        d8_bytes = (nv + d8_cap * 6) if d8_cap is not None else None
        if s6_bytes is not None and (d8_bytes is None
                                     or s6_bytes < d8_bytes):
            return "s6", esc_cap
        if d8_bytes is not None:
            return "d8", d8_cap

    probe_idx = frame_indices[np.unique([0, n // 2, n - 1])]
    if traj.read_frames_packed12(probe_idx, space,
                                 n_threads=n_threads) is not None:
        return "i12", 0
    if traj.read_frames_quantized(probe_idx, space,
                                  n_threads=n_threads) is not None:
        return "i16", 0
    return "f32", 0
