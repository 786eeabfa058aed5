"""The shared frame-batch loop: decode -> device -> kernel -> accumulate,
with the prefetch ring, double-buffered wire, slump detection, and the
fused-program dispatch.

Split out of analysis.py (round 5); the batched-device replacement for
the reference's frame-threading (src/analysis/common.rs)."""

from __future__ import annotations

import logging
import os
import sys
import time as _time
from typing import Optional

import numpy as np

from ..core.order import OrderAccumulator
from ..errors import AnalysisError
from ..input.config import Analysis
from ..io.traj import AtomSubset, Trajectory, check_box_batch
from ..system import System
from .fused import _build_fused_steps, _pop_normal_guard
from .leaflet_runtime import LeafletRuntime
from .normals_runtime import NormalsRuntime
from .wire import (
    _d8_to_int,
    _dequantize,
    _s6_to_int,
    _unpack12,
    _wire_groups,
)

log = logging.getLogger("gorder")


def _effective_batch_size() -> int:
    from .. import analysis as _a

    return _a.DEFAULT_BATCH_SIZE if _a.DEFAULT_BATCH_SIZE \
        else _a._default_batch_size()


# (format, bytes/frame) the most recent _run_batches shipped — benchmark
# observability only, set under the single pipeline-driver thread
_LAST_WIRE = None
# wire bytes the last run actually shipped (observability: paired with the
# timers' 'transfer' seconds this yields the in-trial transfer rate)
_LAST_XFER_BYTES = 0

def _shard_block(n_frames: int, shard, align: int):
    """Contiguous frame-ordinal block for shard (i, n), with the block
    start aligned to the leaflet assignment frequency so every shard owns
    the assignment frames its block consumes."""
    i, n = shard
    base = -(-n_frames // n)                 # ceil
    base = -(-base // max(align, 1)) * max(align, 1)
    start = min(i * base, n_frames)
    end = min(start + base, n_frames)
    return start, end
def _run_batches(analysis: Analysis, system: System, step, normal_vec,
                 n_types: int, n_molecules: int, space: AtomSubset,
                 leaflets: Optional[LeafletRuntime], map_spec=None,
                 geom_mode=None, geom_payload=None,
                 normals: Optional[NormalsRuntime] = None,
                 shard=None, bond_slots=None, geom_spec=None):
    """Shared frame-batch loop: decode → device → kernel → accumulate.

    The decode of batch k+1 runs in a worker thread (the native codec
    releases the GIL) while batch k is transferred and dispatched —
    the batched-device replacement for the reference's frame-threading. Only the
    atoms in `space` (the Master-group equivalent) are decoded and shipped,
    in the most compact exact wire format the data admits: 8-bit temporal
    deltas with sparse corrections (d8), 12-bit packed, int16, or f32 —
    all bit-identical to the f32 decode after device-side reconstruction.

    `shard=(i, n)` restricts the loop to shard i's contiguous frame block
    (docs/SCALING.md): per-frame state (timewise, collected leaflets and
    normals) is indexed by GLOBAL analyzed-frame ordinals, so partial
    results merge exactly.
    """
    classes = ("total", "upper", "lower") if leaflets else ("total",)
    accum = OrderAccumulator(
        n_types, classes,
        keep_timewise=analysis.estimate_error is not None,
    )

    n_out = space.n_out
    traj = Trajectory(analysis.trajectory, expected_atoms=system.n_atoms)
    frame_indices = traj.select_frames(
        analysis.begin if np.isfinite(analysis.begin) else None,
        analysis.end if np.isfinite(analysis.end) else None,
        analysis.step,
    )
    if len(frame_indices) == 0:
        raise AnalysisError(
            "no trajectory frames are within the specified time range")
    if leaflets is not None:
        leaflets.validate(len(frame_indices))
    if normals is not None:
        normals.validate(len(frame_indices))

    full_frame_indices = frame_indices
    shard_start = 0
    if shard is not None:
        align = 1
        if (leaflets is not None and leaflets.classify is not None
                and leaflets.frequency.kind == "every"):
            align = leaflets.frequency.n
        shard_start, shard_end = _shard_block(len(frame_indices), shard,
                                              align)
        frame_indices = frame_indices[shard_start:shard_end]
        log.info("shard %d/%d: frames %d..%d of %d", shard[0], shard[1],
                 shard_start, shard_end, len(full_frame_indices))
        if len(frame_indices) == 0:
            empty_map = None
            if map_spec is not None:
                n_seg = n_types * map_spec.ncells + 1
                empty_map = {cls: np.zeros((4, n_seg), np.int64)
                             for cls in classes}
            return accum, traj, full_frame_indices, empty_map, shard_start

    import concurrent.futures as cf

    import jax

    from ..parallel.context import put_const, put_frames

    # fixed batch size (padded) so every run of a system shares one compile
    batch_size = _effective_batch_size()
    normal_dev = put_const(normal_vec)

    # n_threads maps to decoder threads (frames decode independently); the
    # reference's analysis threading is superseded by device parallelism
    n_threads = max(1, analysis.n_threads)

    if (shard_start > 0 and leaflets is not None
            and leaflets.classify is not None):
        # bootstrap from GLOBAL frame 0: Once-frequency shards inherit its
        # assignment through the carried state, and clustering shards
        # orient against its clusters — the reference's shared
        # reference-clusters design (clustering.rs:66-68) without locks
        c0, b0, _, _ = traj.read_frames(full_frame_indices[:1], space,
                                        n_threads=n_threads)
        box0 = b0[:, [0, 1, 2], [0, 1, 2]]
        assigned0 = np.asarray(leaflets.classify(c0, box0))[0]
        if leaflets.orienter is not None:
            assigned0 = leaflets.orienter.orient(assigned0)
        leaflets.carried = assigned0
        leaflets._logged_stats = True   # frame-0 stats belong to shard 0

    batch_size_probe = _effective_batch_size()
    group_of, n_groups, vgidx = _wire_groups(system, space)
    # Channel-class planning + wire selection (engine/channels.py):
    # decides which decoder side channels this run rides (b7g COG, b7m
    # class plane, b7x aux atoms, b7geo mask bitplane) and picks the
    # most effective wire format for the link
    from .channels import plan_wire_channels

    _plan = plan_wire_channels(
        analysis=analysis, system=system, traj=traj,
        frame_indices=frame_indices, space=space, step=step,
        leaflets=leaflets, normals=normals, map_spec=map_spec,
        geom_mode=geom_mode, geom_spec=geom_spec, bond_slots=bond_slots,
        n_threads=n_threads, batch_size=batch_size_probe, n_out=n_out,
        n_molecules=n_molecules, group_of=group_of, n_groups=n_groups)
    wire, wire_bytes = _plan.wire, _plan.wire_bytes
    corr_cap, esc_cap, n_bonds = _plan.corr_cap, _plan.esc_cap, _plan.n_bonds
    chan_coords = _plan.chan_coords
    channel_classify = _plan.channel_classify
    ch_membrane, ch_heads, ch_axis = (_plan.ch_membrane, _plan.ch_heads,
                                      _plan.ch_axis)
    plane_active, plane_sparse = _plan.plane_active, _plan.plane_sparse
    assign_cap = _plan.assign_cap
    aux_mode, aux_active = _plan.aux_mode, _plan.aux_active
    aux_wire_slots = _plan.aux_wire_slots
    geo_channel = _plan.geo_channel
    # observability for harnesses (bench.py reads this after each run to
    # pair the trial's rate with the wire it actually rode)
    global _LAST_WIRE
    _LAST_WIRE = (wire, wire_bytes)

    # per-batch zero map state: batch tile sums are fetched and accumulated
    # in int64 on the host every batch (exact like the order sums; carrying
    # f32 state across the whole run would overflow the 2^24 exact range)
    map_zero = None
    map_accum = None
    if map_spec is not None:
        from ..core.ordermap import init_map_state

        map_zero = init_map_state(classes, n_types, map_spec)
        n_seg = n_types * map_spec.ncells + 1
        map_accum = {cls: np.zeros((4, n_seg), np.int64)
                     for cls in classes}

    def drain_map_state(state_out):
        for cls, arr in state_out.items():
            map_accum[cls] += np.asarray(arr).astype(np.int64)


    def _drain_extras(result, n_valid):
        """Collect the fused program's extra outputs (export runs): the
        in-program leaflet classes / dynamic normals, exactly the values
        the kernel consumed, in frame order (the in_flight queue drains
        in submission order)."""
        rows = result.pop("_classes", None)
        if rows is not None and leaflets is not None \
                and leaflets.collect_frames is not None:
            arr = np.asarray(rows)
            for i in range(n_valid):
                leaflets.collect_frames.append(
                    arr[i].astype(np.int32).copy())
        nr = result.pop("_normals", None)
        if nr is not None and normals is not None \
                and normals.collected is not None:
            normals.collected.append(np.asarray(nr)[:n_valid])

    geom_sel_dev = None
    geom_point = None
    if geom_mode == "selection":
        geom_sel_dev = put_const(np.asarray(geom_payload, np.int32))
    elif geom_mode == "point":
        geom_point = np.asarray(geom_payload, np.float32)

    n_batches = (len(frame_indices) + batch_size - 1) // batch_size
    from ..io.native import i12_stride

    # Prefetch ring: the decode worker runs up to `prefetch` batches ahead
    # of the driver, so a transfer slump never stalls
    # decoding — when the link recovers, the queued batches ship
    # back-to-back and the run degrades by roughly the slump duration, not
    # by a serialized decode×transfer product.
    prefetch = max(2, int(os.environ.get("GORDER_TPU_PREFETCH", "4")))
    prefetch = min(prefetch, max(2, n_batches))
    if wire == "b7":
        from ..io.native import b7_stride

        buffers = [
            (np.zeros((batch_size, b7_stride(n_bonds)), np.uint8),
             np.zeros((batch_size, esc_cap), np.uint16),
             np.zeros((batch_size, esc_cap), np.int16))
            + ((np.zeros((batch_size, len(ch_heads), 3), np.int32),
                np.zeros(batch_size, np.float32))
               if ch_heads is not None else ())
            + ((np.zeros((batch_size, len(aux_wire_slots), 3), np.int32),)
               if aux_wire_slots is not None else ())
            for _ in range(prefetch)
        ]
    elif wire == "s6":
        from ..io.native import s6_stride

        buffers = [
            (np.zeros((batch_size, s6_stride(n_out)), np.uint8),
             np.zeros((batch_size, esc_cap), np.uint16),
             np.zeros((batch_size, esc_cap), np.int16),
             np.zeros((batch_size, (n_groups + 1) * 3), np.int16))
            for _ in range(prefetch)
        ]
    elif wire == "d8":
        buffers = [
            (np.zeros((batch_size, n_out, 3), np.int8),
             np.zeros((batch_size, corr_cap), np.int32),
             np.zeros((batch_size, corr_cap), np.int16))
            for _ in range(prefetch)
        ]
    elif wire == "i12":
        buffers = [np.zeros((batch_size, i12_stride(n_out)), np.uint8)
                   for _ in range(prefetch)]
    elif wire == "i16":
        buffers = [np.zeros((batch_size, n_out, 3), np.int16)
                   for _ in range(prefetch)]
    else:
        buffers = [np.zeros((batch_size, n_out, 3), np.float32)
                   for _ in range(prefetch)]

    # decoder-COG ring for coordinate wires in the channel class (the b7g
    # wire computes it inline; fallback batches of a b7g run use this too)
    chan_membrane = chan_axis = None
    cog_bufs = None
    if chan_coords is not None:
        chan_membrane, chan_axis = chan_coords[1]
        cog_bufs = [np.zeros(batch_size, np.float32)
                    for _ in range(prefetch)]

    # decoder geometry-mask ring: one (B, stride) u8 bitplane per slot,
    # filled by read_geo_mask for EVERY wire kind in the channel class
    geo_bufs = None
    geo_ref_mode = geo_ref_point = geo_slots_arr = None
    if geo_channel:
        from ..io.native import geo_stride

        geo_bufs = [np.zeros((batch_size, geo_stride(n_bonds)), np.uint8)
                    for _ in range(prefetch)]
        geo_ref_mode = {"point": 0, "center": 1, "selection": 2}[geom_mode]
        if geom_mode == "point":
            geo_ref_point = np.asarray(geom_payload, np.float32)
        elif geom_mode == "selection":
            geo_slots_arr = np.asarray(geom_payload, np.int32)

    # sparse assignment-frame coordinate ring for the b7 class-plane path:
    # (rows int32 (cap,), i16 coords, f32 coords fallback, scale f32) per
    # slot — only the frames that re-classify leaflets are decoded and
    # shipped (1/N of frames for `!every N`, one frame total for `!once`)
    plane_bufs = None
    if plane_sparse:
        plane_bufs = [
            (np.full(assign_cap, batch_size, np.int32),
             np.zeros((assign_cap, n_out, 3), np.int16),
             np.zeros((assign_cap, n_out, 3), np.float32),
             np.ones(assign_cap, np.float32))
            for _ in range(prefetch)
        ]

    from ..utils.timers import timers

    import threading

    # ring-slot gate: the decoder may only reuse buffer b % prefetch after
    # the driver finished shipping batch b - prefetch (put + block — the
    # device owns a copy by then)
    slots = threading.Semaphore(prefetch)

    # On a single-core host the decode thread (throughput work with ring
    # slack) time-slices against the driver thread (latency work: its
    # wakeups gate the link). A small nice on the decode thread lets the
    # driver preempt promptly — measured, this converts driver-wall
    # contention gaps into decode slack without costing decode throughput.
    # Default 5. On multi-core hosts the threads own separate cores and
    # the nice is a no-op.
    decode_nice = int(os.environ.get("GORDER_TPU_DECODE_NICE", "5"))
    _niced = []

    # Same contention, Python side: the interpreter's GIL switch interval
    # (default 5 ms) bounds how fast the driver can take the GIL back from
    # the decode/dispatch threads' numpy slices between transfers.
    # The contended slices are mostly C extensions that hold the GIL
    # regardless of the switch interval, so the default is off.
    switch_s = float(os.environ.get("GORDER_TPU_SWITCH_INTERVAL_MS", "0")) \
        * 1e-3
    prev_switch = sys.getswitchinterval()
    if switch_s > 0:
        sys.setswitchinterval(switch_s)

    def _nice_this_thread():
        if decode_nice <= 0 or _niced:
            return
        _niced.append(True)
        try:
            import ctypes

            libc = ctypes.CDLL("libc.so.6", use_errno=True)
            libc.setpriority(0, threading.get_native_id(), decode_nice)
        except Exception:  # non-Linux / sandboxed: scheduling hint only
            pass

    def _geo_plane(chunk, b):
        """Decoder inside-mask bitplane for this batch (every wire kind in
        the geometry channel class consumes the same mask)."""
        gb = geo_bufs[b % prefetch]
        if len(chunk) < batch_size:
            gb[len(chunk):] = 0
        traj.read_geo_mask(chunk, space, bond_slots[0], bond_slots[1],
                           geom_spec, geo_ref_mode, geo_ref_point,
                           geo_slots_arr, gb,
                           handle_pbc=analysis.handle_pbc,
                           n_threads=n_threads)
        return gb

    def decode_batch(b):
        _nice_this_thread()
        slots.acquire()
        t0 = _time.perf_counter()
        c0 = _time.thread_time()
        try:
            out = _decode_batch(b)
            if geo_channel and out[0][0] != "b7geo":
                # coordinate-wire (or fallback) batches: append the
                # decoder geometry bitplane via the standalone pass (the
                # b7 read computes it inline, returning "b7geo" directly)
                payload, inv, boxes_, nv = out
                kind = payload[0]
                chunk = frame_indices[b * batch_size:(b + 1) * batch_size]
                plane = _geo_plane(chunk, b)
                payload = (kind + "G",) + payload[1:] + (plane,)
                out = (payload, inv, boxes_, nv)
            return out
        finally:
            # wall (includes contention with the driver on a shared core)
            # AND thread-CPU (the decode's intrinsic cost): their ratio is
            # the measured contention factor, and the CPU figure feeds the
            # single-core ceiling the bench publishes
            timers.add("decode", _time.perf_counter() - t0)
            timers.add("decode_cpu", _time.thread_time() - c0)

    def _chan_cog(chunk, b):
        """Per-frame decoder COG for channel-class batches riding a
        coordinate wire — the exact value the b7g side channel ships
        (native/xdr.cpp xtc_cog_axis); padding rows zeroed (masked)."""
        cb = cog_bufs[b % prefetch]
        if len(chunk) < batch_size:
            cb[len(chunk):] = 0
        traj.read_cog_axis(chunk, space, chan_membrane, chan_axis, cb,
                           n_threads=n_threads)
        return cb

    def _fallback_f32(chunk, b):
        """Mid-run fallback: decode as f32 into a fresh zero-padded
        batch-size buffer (jitted shapes never change mid-run)."""
        buf = np.zeros((batch_size, n_out, 3), np.float32)
        _, boxes, times, steps = traj.read_frames(chunk, space,
                                                  n_threads=n_threads,
                                                  out=buf)
        if chan_coords is not None:
            return ("f32g", buf, _chan_cog(chunk, b)), None, boxes, len(chunk)
        return ("f32", buf), None, boxes, len(chunk)

    def _plane_sparse_read(chunk, b):
        """Decode only this batch's leaflet-assignment frames into the
        compact plane ring slot (frequency-gated methods re-classify on
        1/N of frames; the rest carry the previous assignment). Returns
        (rows, i16 coords or None, f32 coords or None, scale or None) —
        quantized when the trajectory admits it (f32(i16)·inv_precision is
        bit-identical to the f32 decode), f32 otherwise."""
        rows_buf, qbuf, fbuf, sbuf = plane_bufs[b % prefetch]
        a0 = shard_start + b * batch_size
        ana = np.arange(a0, a0 + len(chunk), dtype=np.int64)
        src = leaflets.assignment_source(ana)
        pos = np.nonzero(src == ana)[0]
        rows_buf[:] = batch_size          # out-of-range rows drop
        rows_buf[:len(pos)] = pos
        if not len(pos):
            return (rows_buf, None, None, None)
        res = traj.read_frames_quantized(chunk[pos], space,
                                         n_threads=n_threads, out=qbuf)
        if res is not None:
            sbuf[:len(pos)] = res[1]
            qbuf[len(pos):] = 0
            return (rows_buf, qbuf, None, sbuf)
        traj.read_frames(chunk[pos], space, n_threads=n_threads, out=fbuf)
        fbuf[len(pos):] = 0
        return (rows_buf, None, fbuf, None)

    def _decode_batch(b):
        chunk = frame_indices[b * batch_size:(b + 1) * batch_size]
        buf = buffers[b % prefetch]
        if wire == "b7":
            pk, eg, ev = buf[:3]
            aux = cog = None
            if ch_heads is not None:
                aux, cog = buf[3], buf[4]
            elif aux_wire_slots is not None:
                aux = buf[3]
            if len(chunk) < batch_size:
                # padding rows decode to the (masked) base differences
                pk[len(chunk):] = 0
                eg[len(chunk):] = 0
                ev[len(chunk):] = 0
                if aux is not None:
                    aux[len(chunk):] = 0
                if cog is not None:
                    cog[len(chunk):] = 0
            geo_buf = None
            if geo_channel:
                # inline geometry mask channel: the b7 decode computes the
                # bitplane from its own integers — one decode per frame,
                # not a second standalone pass
                geo_buf = geo_bufs[b % prefetch]
                if len(chunk) < batch_size:
                    geo_buf[len(chunk):] = 0
            res, _ = traj.read_frames_b7(chunk, space, bond_slots[0],
                                         bond_slots[1], pk, eg, ev,
                                         n_threads=n_threads,
                                         aux_slots=(ch_heads
                                                    if ch_heads is not None
                                                    else aux_wire_slots),
                                         aux_out=aux,
                                         cog_slots=ch_membrane,
                                         cog_axis=ch_axis, cog_out=cog,
                                         geo=((geom_spec, geo_ref_mode,
                                               geo_ref_point, geo_slots_arr,
                                               analysis.handle_pbc)
                                              if geo_channel else None),
                                         geo_out=geo_buf)
            if res is not None:
                base, inv_prec, boxes, times, steps = res
                if geo_channel:
                    return (("b7geo", pk, eg, ev, base, geo_buf),
                            inv_prec, boxes, len(chunk))
                if ch_heads is not None:
                    return (("b7g", pk, eg, ev, base, aux, cog),
                            inv_prec, boxes, len(chunk))
                if aux is not None:
                    return (("b7x", pk, eg, ev, base, aux),
                            inv_prec, boxes, len(chunk))
                if plane_active:
                    extra = _plane_sparse_read(chunk, b) \
                        if plane_sparse else None
                    return (("b7p", pk, eg, ev, base, extra),
                            inv_prec, boxes, len(chunk))
                return ("b7", pk, eg, ev, base), inv_prec, boxes, len(chunk)
            log.warning(
                "wire fallback: batch %d exceeds the b7 format (escape "
                "demand or value range changed mid-run); shipping int16",
                b)
            res = traj.read_frames_quantized(chunk, space,
                                             n_threads=n_threads)
            if res is not None:
                coords, inv_prec, boxes, times, steps = res
                out = np.zeros((batch_size, n_out, 3), np.int16)
                out[:len(chunk)] = coords[:len(chunk)]
                if chan_coords is not None:
                    return ("i16g", out, _chan_cog(chunk, b)), inv_prec, \
                        boxes, len(chunk)
                return ("i16", out), inv_prec, boxes, len(chunk)
            return _fallback_f32(chunk, b)
        if wire == "s6":
            pk, eg, ev, gm = buf
            if len(chunk) < batch_size:
                # padding rows decode to the (masked) base frame
                pk[len(chunk):] = 0
                eg[len(chunk):] = 0
                ev[len(chunk):] = 0
                gm[len(chunk):] = 0
            res, _ = traj.read_frames_s6(chunk, space, group_of, n_groups,
                                         pk, eg, ev, gm,
                                         n_threads=n_threads)
            if res is not None:
                base, inv_prec, boxes, times, steps = res
                if chan_coords is not None:
                    return ("s6g", pk, eg, ev, gm, base,
                            _chan_cog(chunk, b)), inv_prec, boxes, len(chunk)
                return ("s6", pk, eg, ev, gm, base), inv_prec, boxes, \
                    len(chunk)
            log.warning(
                "wire fallback: batch %d exceeds the s6 format (escape "
                "demand or value range changed mid-run); shipping int16",
                b)
            res = traj.read_frames_quantized(chunk, space,
                                             n_threads=n_threads)
            if res is not None:
                coords, inv_prec, boxes, times, steps = res
                out = np.zeros((batch_size, n_out, 3), np.int16)
                out[:len(chunk)] = coords[:len(chunk)]
                if chan_coords is not None:
                    return ("i16g", out, _chan_cog(chunk, b)), inv_prec, \
                        boxes, len(chunk)
                return ("i16", out), inv_prec, boxes, len(chunk)
            return _fallback_f32(chunk, b)
        if wire == "d8":
            lo, ci, ch = buf
            if len(chunk) < batch_size:
                # zero padding rows: stale deltas would otherwise flow
                # through the on-device cumsum into (masked) frames
                lo[len(chunk):] = 0
            res, _ = traj.read_frames_delta8(chunk, space, lo, ci, ch,
                                             n_threads=n_threads)
            if res is not None:
                abs0, inv_prec, boxes, times, steps = res
                if chan_coords is not None:
                    return ("d8g", lo, ci, ch, abs0,
                            _chan_cog(chunk, b)), inv_prec, boxes, len(chunk)
                return ("d8", lo, ci, ch, abs0), inv_prec, boxes, len(chunk)
            log.warning(
                "wire fallback: batch %d exceeds the d8 format (correction "
                "demand or compression precision changed mid-run); shipping "
                "int16", b)
            res = traj.read_frames_quantized(chunk, space,
                                             n_threads=n_threads)
            if res is not None:
                coords, inv_prec, boxes, times, steps = res
                out = np.zeros((batch_size, n_out, 3), np.int16)
                out[:len(chunk)] = coords[:len(chunk)]
                if chan_coords is not None:
                    return ("i16g", out, _chan_cog(chunk, b)), inv_prec, \
                        boxes, len(chunk)
                return ("i16", out), inv_prec, boxes, len(chunk)
            return _fallback_f32(chunk, b)
        if wire == "i12":
            res = traj.read_frames_packed12(chunk, space, out=buf,
                                            n_threads=n_threads)
            if res is not None:
                coords, inv_prec, boxes, times, steps = res
                if chan_coords is not None:
                    return ("i12g", buf, _chan_cog(chunk, b)), inv_prec, \
                        boxes, len(chunk)
                return ("i12", buf), inv_prec, boxes, len(chunk)
            return _fallback_f32(chunk, b)
        if wire == "i16":
            res = traj.read_frames_quantized(chunk, space, out=buf,
                                             n_threads=n_threads)
            if res is not None:
                coords, inv_prec, boxes, times, steps = res
                if chan_coords is not None:
                    return ("i16g", buf, _chan_cog(chunk, b)), inv_prec, \
                        boxes, len(chunk)
                return ("i16", buf), inv_prec, boxes, len(chunk)
            return _fallback_f32(chunk, b)
        coords, boxes, times, steps = traj.read_frames(
            chunk, space, n_threads=n_threads, out=buf)
        if chan_coords is not None:
            return ("f32g", buf, _chan_cog(chunk, b)), None, boxes, \
                len(chunk)
        return ("f32", buf), None, boxes, len(chunk)

    from ..utils.progress import ProgressPrinter

    executor = cf.ThreadPoolExecutor(max_workers=1)
    dispatch_pool = cf.ThreadPoolExecutor(max_workers=1)
    disp_slots = threading.Semaphore(8)
    progress = ProgressPrinter(len(frame_indices)) \
        if not analysis.silent else None
    in_flight = []  # (dispatch future, n_valid): drained after the loop
    # The CPU backend ALIASES numpy buffers in device_put (zero-copy, and
    # block_until_ready does not materialize them) — deferred execution
    # would read decode buffers after they were rewritten. Synchronous
    # per-batch fetches force consumption and cost nothing locally.
    # Accelerator backends perform real transfers, so fetches are deferred
    # and the device works on batch b while batch b+1 decodes.
    sync_fetch = jax.default_backend() == "cpu"

    # constant per-run device arrays, shipped once instead of per batch
    mask_full_dev = put_frames(np.ones(batch_size, bool))
    vgidx_dev = put_const(vgidx) if wire == "s6" else None

    # Fused per-batch programs: wire reconstruction (+ eligible leaflet
    # classification / dynamic normals) traced inline into the order
    # kernel — ONE XLA program per batch. Runtimes with carried or
    # collected host state keep the two-dispatch path.
    from ..parallel.context import active_mesh

    fused_get = None
    # every-frame global/local/individual leaflet classification and
    # dynamic normals are pure functions of the batch: trace them into the
    # fused program so the (B, M) classes / (B, M, 3) normals never leave
    # the device (the two-dispatch path round-trips them through the host).
    # Collection (export) runs stay fused too: the program returns the
    # in-program classes / normals as extra outputs, drained host-side
    # (engine/fused.py) — export rows keep the compact wires.
    fused_classify = (leaflets.fused_classify_impl(ignore_collect=True)
                      if leaflets is not None else None)
    fused_normals = (normals.fused_impl(ignore_collect=True)
                     if normals is not None else None)
    collect_classes = (fused_classify is not None
                       and leaflets.collect_frames is not None)
    collect_normals = (fused_normals is not None
                       and normals.collected is not None)
    if ((leaflets is None or fused_classify is not None)
            and (normals is None or fused_normals is not None)):
        fused_get = _build_fused_steps(step, n_out=n_out,
                                       classify_impl=fused_classify,
                                       normals_impl=fused_normals,
                                       channel_classify=channel_classify,
                                       channel_coords_classify=(
                                           chan_coords[0]
                                           if chan_coords is not None
                                           else None),
                                       aux_classify=(aux_mode[1]
                                                     if aux_active else None),
                                       aux_normals=(aux_mode[2]
                                                    if aux_active else None),
                                       n_bonds=n_bonds,
                                       collect_classes=collect_classes,
                                       collect_normals=collect_normals)
        if (fused_get is not None and leaflets is not None
                and not leaflets._logged_stats):
            # the fused path never materializes classes on the host;
            # reproduce the reference's first-frame population log
            # (topology/mod.rs:178-225) from one cheap frame-0 read —
            # classified against the decoder COG when this run is in the
            # channel class, so the logged populations match the run
            c0, b0, _, _ = traj.read_frames(frame_indices[:1], space,
                                            n_threads=n_threads)
            box0 = b0[:, [0, 1, 2], [0, 1, 2]]
            if chan_coords is not None:
                cog0 = np.zeros(1, np.float32)
                traj.read_cog_axis(frame_indices[:1], space, chan_membrane,
                                   chan_axis, cog0)
                cls0 = leaflets._channel_classify_host(c0, cog0, box0)[0]
            else:
                cls0 = np.asarray(leaflets.classify(c0, box0))[0]
            if leaflets.flip:
                cls0 = 1 - cls0
            leaflets._log_first_stats(cls0.astype(np.int32))

    # b7 class-plane machinery: the fused "b7m" program consumes the
    # host-computed (B, M) classes as a wire operand; sparse
    # assignment-frame coordinates (frequency-gated methods) scatter into
    # a full-shape zero batch on the device so the SAME classify program
    # as the coordinate-wire path runs on them (per-frame math is
    # row-independent, so assignment rows are bitwise identical to a
    # coordinate-wire run)
    fused_plane_get = None
    plane_scatter_q = plane_scatter_f = None
    if plane_active:
        fused_plane_get = _build_fused_steps(step, n_out=n_out)
    if plane_sparse:
        import jax.numpy as jnp

        _mesh = active_mesh()

        def _scatter_f_impl(comp, rows):
            out = jnp.zeros((batch_size, n_out, 3), jnp.float32)
            out = out.at[rows].set(comp, mode="drop")
            if _mesh is not None:
                from ..parallel.mesh import batch_sharding

                out = jax.lax.with_sharding_constraint(
                    out, batch_sharding(_mesh))
            return out

        def _scatter_q_impl(comp, rows, scale):
            # f32(i16) * inv_precision — bit-identical to the f32 decode
            return _scatter_f_impl(
                comp.astype(jnp.float32) * scale[:, None, None], rows)

        plane_scatter_f = jax.jit(_scatter_f_impl)
        plane_scatter_q = jax.jit(_scatter_q_impl)

    geom_point_dev = None
    if geom_mode == "point":
        geom_point_dev = put_frames(np.tile(geom_point, (batch_size, 1)))
    # numpy jit args are allowed when the fused program dispatches from
    # the worker thread on a single device: the worker's jit call absorbs
    # each small per-batch put's latency that would otherwise stall the
    # driver between bulk transfers
    host_args_ok = ((fused_get is not None or fused_plane_get is not None)
                    and not sync_fetch
                    and active_mesh() is None)
    # per-batch device arrays that rarely change (NVT boxes, constant XTC
    # precision): reuse the previous device copy when the host values match
    last_box = last_box_dev = None
    last_geom_center_dev = None
    last_scale = last_scale_dev = None

    import collections as _collections

    batch_walls = _collections.deque(maxlen=15)
    slump_count = 0
    xfer_bytes = 0

    def ship(*arrays):
        """Put per-frame wire arrays and block: timed as 'transfer' and
        byte-counted, so the bench can report the transfer rate the
        pipeline actually achieved in-trial (not a separate probe's
        cold-window estimate)."""
        nonlocal xfer_bytes
        t0 = _time.perf_counter()
        devs = tuple(put_frames(a) for a in arrays)
        jax.block_until_ready(devs)
        timers.add("transfer", _time.perf_counter() - t0)
        xfer_bytes += sum(a.nbytes for a in arrays)
        return devs

    def ship_const(*arrays):
        """Like ship(), but replicated placement — for per-batch arrays
        whose leading axis is not the frame axis (the compact
        assignment-frame coordinate rows of the b7 class-plane path)."""
        nonlocal xfer_bytes
        t0 = _time.perf_counter()
        devs = tuple(put_const(a) for a in arrays)
        jax.block_until_ready(devs)
        timers.add("transfer", _time.perf_counter() - t0)
        xfer_bytes += sum(a.nbytes for a in arrays)
        return devs

    def dispatch(thunk):
        """Kernel dispatch: timed so the client-side enqueue cost is
        visible separately from transfer and decode. Runs on the dispatch
        worker thread for accelerator backends, inline for the CPU
        backend."""
        t0 = _time.perf_counter()
        try:
            out = thunk()
            if not sync_fetch:
                # start the tiny (4, T)-row D2H now, riding behind the
                # next batches' bulk H2D, so the end-of-run drain finds
                # host data instead of paying ~one RTT per batch
                for leaf in jax.tree_util.tree_leaves(out):
                    copy_async = getattr(leaf, "copy_to_host_async", None)
                    if copy_async is not None:
                        copy_async()
            return out
        finally:
            disp_slots.release()
            timers.add("dispatch", _time.perf_counter() - t0)

    try:
        futures = _collections.deque(
            executor.submit(decode_batch, b) for b in range(n_batches))
        for b in range(n_batches):
            t_iter = _time.perf_counter()
            with timers.phase("wait"):
                payload, inv_prec, boxes, n_valid = \
                    futures.popleft().result()
            c_iter = _time.thread_time()

            scale = None
            if inv_prec is not None:
                scale = np.ones(batch_size, np.float32)
                scale[:n_valid] = inv_prec
                if n_valid and n_valid < batch_size:
                    # padding rows reuse the last real scale so d8's cumsum
                    # tail dequantizes without overflow surprises
                    scale[n_valid:] = inv_prec[n_valid - 1]

            if scale is None:
                scale_dev = None
            elif last_scale is not None and np.array_equal(scale, last_scale):
                scale_dev = last_scale_dev
            else:
                scale_dev = put_frames(scale)
                last_scale, last_scale_dev = scale, scale_dev

            kind = payload[0]
            # channel-class coordinate wires carry a trailing per-frame
            # decoder COG: strip it here, re-append to the fused program's
            # operand tuple (or hand it to classes_for_batch) below
            chan_cog = None
            geo_arr = None
            if kind in ("s6g", "d8g", "i12g", "i16g", "f32g"):
                chan_cog = payload[-1].copy()   # ring buffer: copy out
                payload = (kind[:-1],) + payload[1:-1]
                wire_kind = kind
                kind = kind[:-1]
            elif kind in ("s6G", "d8G", "i12G", "i16G", "f32G"):
                # geometry channel class on a coordinate wire: the
                # trailing decoder bitplane ships as an extra operand of
                # the *G fused kind
                geo_arr = payload[-1]
                payload = (kind[:-1],) + payload[1:-1]
                wire_kind = kind
                kind = kind[:-1]
            else:
                wire_kind = kind
            coords_dev = None      # f32 coords (or None until reconstructed)
            quant_dev = None       # int16 absolutes awaiting dequantization
            wire_devs = None       # raw wire arrays for the fused programs
            if kind == "b7":
                _, pk, eg, ev, base = payload
                pk_dev, eg_dev, ev_dev = ship(pk, eg, ev)
                base_dev = base if host_args_ok else put_const(base)
                wire_devs = (pk_dev, eg_dev, ev_dev, base_dev)
                assert fused_get is not None, \
                    "b7 wire requires the fused bond-order path"
            elif kind == "b7p":
                # b7 + host leaflet-class plane: classes are computed
                # below (after box_dev exists) and appended as the fifth
                # "b7m" wire operand
                _, pk, eg, ev, base, plane_extra = payload
                pk_dev, eg_dev, ev_dev = ship(pk, eg, ev)
                base_dev = base if host_args_ok else put_const(base)
                wire_devs = (pk_dev, eg_dev, ev_dev, base_dev)
                assert fused_plane_get is not None, \
                    "b7p wire requires the fused class-plane path"
            elif kind == "b7x":
                _, pk, eg, ev, base, aux = payload
                pk_dev, eg_dev, ev_dev, aux_dev = ship(pk, eg, ev, aux)
                base_dev = base if host_args_ok else put_const(base)
                wire_devs = (pk_dev, eg_dev, ev_dev, base_dev, aux_dev)
                assert fused_get is not None, \
                    "b7x wire requires the fused aux-channel path"
            elif kind == "b7geo":
                _, pk, eg, ev, base, geo = payload
                pk_dev, eg_dev, ev_dev, geo_dev = ship(pk, eg, ev, geo)
                base_dev = base if host_args_ok else put_const(base)
                wire_devs = (pk_dev, eg_dev, ev_dev, base_dev, geo_dev)
                assert fused_get is not None, \
                    "b7geo wire requires the fused geometry-channel path"
            elif kind == "b7g":
                _, pk, eg, ev, base, aux, cog = payload
                pk_dev, eg_dev, ev_dev, aux_dev = ship(pk, eg, ev, aux)
                base_dev = base if host_args_ok else put_const(base)
                cog_dev = (cog.copy() if host_args_ok
                           else put_frames(cog.copy()))
                wire_devs = (pk_dev, eg_dev, ev_dev, base_dev, aux_dev,
                             cog_dev)
                assert fused_get is not None, \
                    "b7g wire requires the fused bond-order path"
            elif kind == "s6":
                _, pk, eg, ev, gm, base = payload
                pk_dev, eg_dev, ev_dev, gm_dev = ship(pk, eg, ev, gm)
                base_dev = base if host_args_ok else put_const(base)
                wire_devs = (pk_dev, eg_dev, ev_dev, base_dev, gm_dev,
                             vgidx_dev)
                if fused_get is None:
                    quant_dev = _s6_to_int(pk_dev, eg_dev, ev_dev, base_dev,
                                           gm_dev, vgidx_dev)
            elif kind == "d8":
                _, lo, ci, ch, abs0 = payload
                lo_dev, ci_dev, ch_dev = ship(lo, ci, ch)
                abs0_dev = abs0 if host_args_ok else put_const(abs0)
                wire_devs = (lo_dev, ci_dev, ch_dev, abs0_dev)
                if fused_get is None:
                    quant_dev = _d8_to_int(lo_dev, ci_dev, ch_dev, abs0_dev)
            elif kind == "i12":
                packed_dev, = ship(payload[1])
                wire_devs = (packed_dev,)
                if fused_get is None:
                    quant_dev = _unpack12(packed_dev, n_out)
            elif kind == "i16":
                quant_dev, = ship(payload[1])
                wire_devs = (quant_dev,)
            else:
                coords_dev, = ship(payload[1])
                wire_devs = (coords_dev,)
                scale_dev = None
            if geo_arr is not None:
                geo_dev, = ship(geo_arr)
                wire_devs = wire_devs + (geo_dev,)

            if analysis.handle_pbc:
                check_box_batch(boxes[:n_valid])
            box_arr = np.ones((batch_size, 3), np.float32)
            box_arr[:n_valid] = boxes[:n_valid, [0, 1, 2], [0, 1, 2]]
            if n_valid == batch_size:
                frame_mask_dev = mask_full_dev
            else:
                frame_mask = np.zeros(batch_size, bool)
                frame_mask[:n_valid] = True
                frame_mask_dev = put_frames(frame_mask)
            if last_box is not None and np.array_equal(box_arr, last_box):
                if last_box_dev is None:
                    # second consecutive batch with this box: pin it on
                    # the device once, then every later batch passes the
                    # device handle at zero per-batch cost (NVT boxes
                    # never change; the worker-thread put below still
                    # holds the GIL against the driver on 1-core hosts)
                    last_box_dev = put_frames(box_arr)
                    last_geom_center_dev = None
                box_dev = last_box_dev
            elif host_args_ok:
                # numpy arg: the jit call device_puts it on the DISPATCH
                # worker, so the ~one-RTT latency of this tiny per-batch
                # put rides behind the bulk transfer instead of stalling
                # the driver
                box_dev = box_arr
                last_box, last_box_dev = box_arr, None
                last_geom_center_dev = None
            else:
                box_dev = put_frames(box_arr)
                last_box, last_box_dev = box_arr, box_dev
                last_geom_center_dev = None

            if geom_mode == "selection":
                geom_ref = geom_sel_dev
            elif geom_mode == "point":
                geom_ref = geom_point_dev
            elif geom_mode == "center":
                if last_box_dev is not None and box_dev is last_box_dev:
                    if last_geom_center_dev is None:
                        last_geom_center_dev = put_frames(box_arr * 0.5)
                    geom_ref = last_geom_center_dev
                elif host_args_ok:
                    geom_ref = box_arr * 0.5
                else:
                    geom_ref = put_frames(box_arr * 0.5)
            else:
                geom_ref = None

            analyzed = np.arange(shard_start + b * batch_size,
                                 shard_start + b * batch_size + n_valid,
                                 dtype=np.int64)
            if kind == "b7p":
                # host classes plane: manual tables index straight into
                # the table; frequency-gated methods classify the sparse
                # assignment frames (scattered to their batch rows on the
                # device — bitwise identical to a coordinate-wire run)
                # and carry between them. classes_for_batch also handles
                # flip, orienter matching, collection, and the first-frame
                # population log.
                coords_sc = None
                if plane_extra is not None:
                    rows, qc, fc, sc = plane_extra
                    if qc is not None:
                        qd, = ship_const(qc)
                        coords_sc = plane_scatter_q(qd, rows.copy(),
                                                    sc.copy())
                    elif fc is not None:
                        fd, = ship_const(fc)
                        coords_sc = plane_scatter_f(fd, rows.copy())
                classes_arr = leaflets.classes_for_batch(
                    coords_sc, box_dev, analyzed)
                if classes_arr.shape[0] < batch_size:
                    classes_arr = np.concatenate([
                        classes_arr,
                        np.zeros((batch_size - classes_arr.shape[0],
                                  n_molecules), np.int32)])
                classes_arr = np.ascontiguousarray(classes_arr)
                if host_args_ok:
                    # fresh per-batch array: the dispatch worker's jit
                    # call device_puts it, riding behind the bulk
                    # transfer instead of stalling the driver
                    classes_dev = classes_arr
                else:
                    classes_dev, = ship(classes_arr)
                w_plane = wire_devs + (classes_dev,)

                def thunk(w=w_plane, s=scale_dev, bx=box_dev,
                          fm=frame_mask_dev):
                    return fused_plane_get("b7m")(w, s, bx, normal_dev,
                                                  fm, None, None)
            elif fused_get is not None:
                # single dispatch: decode + kernel in one compiled program;
                # the call runs on the dispatch worker so its client-side
                # RPC wait never serializes with the next batch's transfer
                if chan_cog is not None:
                    cog_dev = (chan_cog if host_args_ok
                               else put_frames(chan_cog))
                    wire_devs = wire_devs + (cog_dev,)

                def thunk(k=wire_kind, w=wire_devs, s=scale_dev, bx=box_dev,
                          fm=frame_mask_dev, gr=geom_ref):
                    return fused_get(k)(w, s, bx, normal_dev, fm,
                                        map_zero, gr)
            elif leaflets is not None or normals is not None:
                # these subsystems consume f32 coordinates, and their
                # carried/collected state needs host values per batch
                if coords_dev is not None:
                    coords_f32 = coords_dev
                else:
                    coords_f32 = _dequantize(quant_dev, scale_dev)
                if normals is not None:
                    normal_arg = normals.normals_for_batch(
                        coords_f32, box_dev, analyzed, batch_size,
                        geom_ref=geom_ref)
                    normal_arg = put_frames(np.asarray(normal_arg)
                                            if isinstance(normal_arg,
                                                          np.ndarray)
                                            else np.asarray(normal_arg))
                else:
                    normal_arg = normal_dev
                if leaflets is not None:
                    classes_arr = leaflets.classes_for_batch(
                        coords_f32, box_dev, analyzed,
                        channel_cog=chan_cog)
                    if classes_arr.shape[0] < batch_size:
                        classes_arr = np.concatenate([
                            classes_arr,
                            np.zeros((batch_size - classes_arr.shape[0],
                                      n_molecules), np.int32)])
                    classes_dev = put_frames(classes_arr)
                else:
                    classes_dev = None
                if quant_dev is not None:
                    # keep the kernel on the INTEGER coords so its bond
                    # vectors take the single-rounding integer-difference
                    # path (bit-identical to the fused programs / b7)
                    def thunk(q=quant_dev, bx=box_dev, na=normal_arg,
                              fm=frame_mask_dev, cl=classes_dev,
                              s=scale_dev, gr=geom_ref):
                        return step(q, bx, na, fm, cl, inv_scale=s,
                                    map_state=map_zero, geom_ref=gr)
                else:
                    def thunk(c=coords_f32, bx=box_dev, na=normal_arg,
                              fm=frame_mask_dev, cl=classes_dev,
                              gr=geom_ref):
                        return step(c, bx, na, fm, cl, map_state=map_zero,
                                    geom_ref=gr)
            elif coords_dev is not None:
                def thunk(c=coords_dev, bx=box_dev, fm=frame_mask_dev,
                          gr=geom_ref):
                    return step(c, bx, normal_dev, fm, map_state=map_zero,
                                geom_ref=gr)
            else:
                # dequantization fuses into the kernel
                def thunk(q=quant_dev, bx=box_dev, fm=frame_mask_dev,
                          s=scale_dev, gr=geom_ref):
                    return step(q, bx, normal_dev, fm, inv_scale=s,
                                map_state=map_zero, geom_ref=gr)
            if sync_fetch:
                result, map_out = dispatch(thunk)
                with timers.phase("compute"):
                    result = dict(result)
                    _pop_normal_guard(result)
                    _drain_extras(result, n_valid)
                    accum.add_batch(
                        {k: np.asarray(v) for k, v in result.items()},
                        n_valid)
                    if map_out is not None:
                        drain_map_state(map_out)
            else:
                # async: the dispatch worker owns the (network-latent) jit
                # call; the driver proceeds straight to the next batch's
                # transfer. disp_slots bounds in-flight executions so HBM
                # holds at most a few batches of wire input
                disp_slots.acquire()
                in_flight.append(
                    (dispatch_pool.submit(dispatch, thunk), n_valid))
            # batch b has fully left its host buffers (put + block above, or
            # synchronous consumption): the decoder may reuse the ring slot
            slots.release()
            timers.add("driver_cpu", _time.thread_time() - c_iter)
            wall = _time.perf_counter() - t_iter
            if len(batch_walls) >= 5:
                med = sorted(batch_walls)[len(batch_walls) // 2]
                if wall > max(3.0 * med, 0.25):
                    slump_count += 1
                    log.warning(
                        "transfer slump: batch %d took %.2fs (rolling median "
                        "%.2fs); decode continues into the prefetch ring",
                        b, wall, med)
            batch_walls.append(wall)
            if progress is not None:
                progress.update(min((b + 1) * batch_size,
                                    len(frame_indices)))
            if b % 16 == 15:
                log.info("dispatched %d / %d frames",
                         min((b + 1) * batch_size, len(frame_indices)),
                         len(frame_indices))
    finally:
        # unblock a decode waiting on a ring slot before joining the worker
        # (exception paths would otherwise deadlock executor.shutdown)
        for _ in range(prefetch + 1):
            slots.release()
        for _ in range(16):
            disp_slots.release()
        executor.shutdown(wait=True, cancel_futures=True)
        dispatch_pool.shutdown(wait=True)
        if switch_s > 0:
            sys.setswitchinterval(prev_switch)
        if progress is not None:
            progress.finish()
    if slump_count:
        log.info("%d transfer slump(s) absorbed by the prefetch ring",
                 slump_count)

    with timers.phase("compute"):
        for fut, n_valid in in_flight:
            result, map_out = fut.result()
            result = dict(result)
            _pop_normal_guard(result)
            _drain_extras(result, n_valid)
            accum.add_batch({k: np.asarray(v) for k, v in result.items()},
                            n_valid)
            if map_out is not None:
                drain_map_state(map_out)

    global _LAST_XFER_BYTES
    _LAST_XFER_BYTES = xfer_bytes
    log.info("analyzed %d frames", accum.n_frames)
    return accum, traj, full_frame_indices, map_accum, shard_start
