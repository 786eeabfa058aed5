"""The XLA order step against an independent float64 numpy reference.

Each configuration of the bond-based and united-atom steps — periodic or
not, float or integer (quantized) coordinates, leaflets, per-molecule
normals, ordermaps, the b7 bond-vector wire, geometry selection, the
frames mesh — is checked against a vectorized f64 reimplementation of the
reference's per-sample rule (min-image bond vector, P2, 1e-6 fixed point
rounded half away from zero; tests/test_brute_force.py `quantize`). Sample
counts must match exactly; per-type integer sums may differ by at most one
quantum per sample (f32 on the device against f64 here).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gorder_tpu.core.order import (MAX_EXACT_SAMPLES, limb_reduce,
                                   make_order_step, recombine_limbs)
from gorder_tpu.core.ua import (BOND_LENGTH, CH3_ANGLE, TETRAHEDRAL_ANGLE,
                                TETRAHEDRAL_ANGLE_HALF, make_ua_step)


# ------------------------------------------------------- f64 reference


def quantize64(p2):
    """order.rs:21-26, vectorized: (v·1e6) rounded half away from zero."""
    x = np.asarray(p2, np.float64) * 1e6
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5)) \
        .astype(np.int64)


def min_image64(d, box):
    return d - box * np.round(d / box)


def p2_64(vec, normal):
    """1.5·cos²θ − 0.5 of (B, N, 3) vectors against (B, N, 3) normals."""
    proj = np.sum(vec * normal, axis=-1)
    cos2 = proj * proj / (np.sum(vec * vec, axis=-1)
                          * np.sum(normal * normal, axis=-1))
    return 1.5 * cos2 - 0.5


def reference_sums(q, btype, n_types, weight):
    """(B, N) quantized samples and (B, N) 0/1 weights → per-type int64
    (sums, counts)."""
    sums = np.zeros(n_types, np.int64)
    counts = np.zeros(n_types, np.int64)
    np.add.at(sums, btype, (q * weight).sum(axis=0))
    np.add.at(counts, btype, weight.sum(axis=0).astype(np.int64))
    return sums, counts


def bond_samples(pos, box, atom_a, atom_b, normal, handle_pbc=True):
    """(B, N) quantized samples and (B, N, 3) min-image midpoints."""
    d = pos[:, atom_b] - pos[:, atom_a]
    if handle_pbc:
        d = min_image64(d, box[:, None, :])
    return quantize64(p2_64(d, np.broadcast_to(normal, d.shape))), \
        pos[:, atom_a] + 0.5 * d


def device_sums(out):
    sums, counts = recombine_limbs(np.asarray(out))
    return sums.sum(axis=0), counts.sum(axis=0)


def assert_matches(out, ref):
    sums, counts = device_sums(out)
    ref_sums, ref_counts = ref
    np.testing.assert_array_equal(counts, ref_counts)
    assert counts.sum() > 0
    assert (np.abs(sums - ref_sums) <= ref_counts).all(), (sums, ref_sums)


def problem(seed, B=16, A=64, N=700, T=5, M=10):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, 10, (B, A, 3)).astype(np.float32)
    box = np.full((B, 3), 10.0, np.float32)
    atom_a = rng.integers(0, A, N).astype(np.int32)
    atom_b = rng.integers(0, A, N).astype(np.int32)
    keep = atom_a != atom_b
    atom_a, atom_b = atom_a[keep], atom_b[keep]
    btype = rng.integers(0, T, len(atom_a)).astype(np.int32)
    bmol = rng.integers(0, M, len(atom_a)).astype(np.int32)
    mask = np.ones(B, bool)
    mask[-3:] = False
    return dict(coords=coords, box=box, atom_a=atom_a, atom_b=atom_b,
                btype=btype, bmol=bmol, mask=mask, T=T, M=M, rng=rng)


Z = np.array([0.0, 0.0, 1.0], np.float32)


def frame_weight(p, n_bonds):
    return np.broadcast_to(p["mask"][:, None], (len(p["mask"]), n_bonds)) \
        .astype(np.int64)


# ---------------------------------------------------- bond-based step


@pytest.mark.parametrize("handle_pbc", [True, False])
def test_order_step_matches_f64(handle_pbc):
    p = problem(0)
    step = make_order_step(p["atom_a"], p["atom_b"], p["btype"], p["bmol"],
                           p["T"], p["M"], handle_pbc=handle_pbc)
    out, _ = step(p["coords"], p["box"], Z, p["mask"])
    q, _ = bond_samples(p["coords"].astype(np.float64), p["box"],
                        p["atom_a"], p["atom_b"], Z, handle_pbc)
    assert_matches(out["total"], reference_sums(
        q, p["btype"], p["T"], frame_weight(p, len(p["btype"]))))


def test_order_step_quantized_matches_f64():
    """Integer (XTC) coordinates with a per-frame 1/precision scale."""
    p = problem(1)
    prec = 100.0
    qc = np.round(p["coords"] * prec).astype(np.int16)
    inv = np.full(len(qc), 1.0 / prec, np.float32)
    step = make_order_step(p["atom_a"], p["atom_b"], p["btype"], p["bmol"],
                           p["T"], p["M"])
    out, _ = step(qc, p["box"], np.array([1, 0, 0], np.float32), p["mask"],
                  inv_scale=inv)
    q, _ = bond_samples(qc.astype(np.float64) / prec, p["box"], p["atom_a"],
                        p["atom_b"], np.array([1.0, 0.0, 0.0]))
    assert_matches(out["total"], reference_sums(
        q, p["btype"], p["T"], frame_weight(p, len(p["btype"]))))


def test_order_step_batch_invariance():
    """Two half-batches sum to the full batch exactly."""
    p = problem(2)
    step = make_order_step(p["atom_a"], p["atom_b"], p["btype"], p["bmol"],
                           p["T"], p["M"])
    c, b, m = p["coords"], p["box"], p["mask"]
    full = device_sums(step(c, b, Z, m)[0]["total"])
    h1 = device_sums(step(c[:8], b[:8], Z, m[:8])[0]["total"])
    h2 = device_sums(step(c[8:], b[8:], Z, m[8:])[0]["total"])
    np.testing.assert_array_equal(full[0], h1[0] + h2[0])
    np.testing.assert_array_equal(full[1], h1[1] + h2[1])


def test_order_step_leaflets_match_f64():
    p = problem(7)
    classes = p["rng"].integers(0, 2, (len(p["mask"]), p["M"])) \
        .astype(np.int32)
    step = make_order_step(p["atom_a"], p["atom_b"], p["btype"], p["bmol"],
                           p["T"], p["M"], with_leaflets=True)
    out, _ = step(p["coords"], p["box"], Z, p["mask"], classes)
    q, _ = bond_samples(p["coords"].astype(np.float64), p["box"],
                        p["atom_a"], p["atom_b"], Z)
    w = frame_weight(p, len(p["btype"]))
    cls = classes[:, p["bmol"]]
    for name, weight in (("total", w), ("upper", w * (cls == 0)),
                         ("lower", w * (cls == 1))):
        assert_matches(out[name], reference_sums(q, p["btype"], p["T"],
                                                 weight))
    total, upper, lower = (device_sums(out[c])
                           for c in ("total", "upper", "lower"))
    np.testing.assert_array_equal(total[0], upper[0] + lower[0])
    np.testing.assert_array_equal(total[1], upper[1] + lower[1])


def test_order_step_per_molecule_normal_matches_f64():
    """Un-normalized per-molecule normals: the step divides by |n|²."""
    p = problem(11)
    normals = (p["rng"].normal(0, 1, (len(p["mask"]), p["M"], 3))
               .astype(np.float32) * 2.5)
    step = make_order_step(p["atom_a"], p["atom_b"], p["btype"], p["bmol"],
                           p["T"], p["M"], normal_mode="per_molecule")
    out, _ = step(p["coords"], p["box"], normals, p["mask"])
    q, _ = bond_samples(p["coords"].astype(np.float64), p["box"],
                        p["atom_a"], p["atom_b"],
                        normals[:, p["bmol"]].astype(np.float64))
    assert_matches(out["total"], reference_sums(
        q, p["btype"], p["T"], frame_weight(p, len(p["btype"]))))


def test_ordermap_tiles_match_f64():
    """Nearest-tile binning of the min-image bond midpoints
    (ordermap.rs): every tile's count is exact, every tile sum within one
    quantum per sample."""
    from gorder_tpu.core.ordermap import MapSpec, init_map_state

    p = problem(9)
    spec = MapSpec(ax0=0, ax1=1, start0=0.0, start1=0.0, bin0=1.0,
                   bin1=1.0, n0=11, n1=11, end0=10.0, end1=10.0)
    step = make_order_step(p["atom_a"], p["atom_b"], p["btype"], p["bmol"],
                           p["T"], p["M"], map_spec=spec)
    out, state = step(p["coords"], p["box"], Z, p["mask"],
                      map_state=init_map_state(("total",), p["T"], spec))
    q, mid = bond_samples(p["coords"].astype(np.float64), p["box"],
                          p["atom_a"], p["atom_b"], Z)
    w = frame_weight(p, len(p["btype"]))
    assert_matches(out["total"], reference_sums(q, p["btype"], p["T"], w))

    pos = mid[..., :2] / 1.0 + 0.5
    # the data keeps every midpoint clear of a tile edge, so f32 and f64
    # bin identically
    assert np.abs(pos - np.round(pos)).min() > 1e-5
    i0, i1 = np.floor(pos[..., 0]).astype(int), np.floor(pos[..., 1]) \
        .astype(int)
    ok = (i0 >= 0) & (i0 < 11) & (i1 >= 0) & (i1 < 11)
    cell = p["btype"][None, :] * 121 + i0 * 11 + i1
    want_sum = np.zeros(p["T"] * 121, np.int64)
    want_cnt = np.zeros(p["T"] * 121, np.int64)
    np.add.at(want_sum, cell[ok], (q * w)[ok])
    np.add.at(want_cnt, cell[ok], w[ok])
    arr = np.asarray(state["total"])[:, :-1].astype(np.int64)
    got_sum = arr[0] * 16384 + arr[1] * 128 + arr[2]
    np.testing.assert_array_equal(arr[3], want_cnt)
    assert (np.abs(got_sum - want_sum) <= want_cnt).all()


def test_b7_diff_input_matches_f64():
    """The b7 wire's integer bond differences, dequantized in the step."""
    p = problem(5)
    prec = 100.0
    qc = np.round(p["coords"] * prec)
    d = (qc[:, p["atom_b"]] - qc[:, p["atom_a"]]).astype(np.int32)
    inv = np.full(len(qc), 1.0 / prec, np.float32)
    step = make_order_step(p["atom_a"], p["atom_b"], p["btype"], p["bmol"],
                           p["T"], p["M"])
    out, _ = step.impl(jnp.asarray(d), jnp.asarray(p["box"]), jnp.asarray(Z),
                       jnp.asarray(p["mask"]), inv_scale=jnp.asarray(inv),
                       diff_input=True)
    q, _ = bond_samples(qc / prec, p["box"], p["atom_a"], p["atom_b"], Z)
    assert_matches(out["total"], reference_sums(
        q, p["btype"], p["T"], frame_weight(p, len(p["btype"]))))


def test_b7_wire_residuals_match_f64(tmp_path):
    """The native encoder's b7 residual wire, reconstructed on the device
    (engine/wire.py _b7_impl), through the order step."""
    from gorder_tpu.engine.wire import _b7_impl
    from gorder_tpu.io.native import b7_stride
    from gorder_tpu.io.traj import AtomSubset, Trajectory

    from . import synthetic

    from gorder_tpu.io.gro import read_gro

    gro, _, xtc = synthetic.make_flat_bilayer(tmp_path, tag="b7res")
    n_atoms = len(read_gro(gro).atom_names)
    space = AtomSubset.prefix(n_atoms)
    traj = Trajectory(xtc)
    idx = traj.select_frames(None, None, 1)
    c16, inv, boxes, _, _ = traj.read_frames_quantized(idx, space)
    heads = np.arange(0, n_atoms, 4)
    atom_a = np.concatenate([heads, heads + 1, heads + 2]).astype(np.int32)
    atom_b = atom_a + 1
    btype = np.repeat(np.arange(3), len(heads)).astype(np.int32)
    bmol = np.tile(np.arange(len(heads)), 3).astype(np.int32)
    pk = np.zeros((len(idx), b7_stride(len(atom_a))), np.uint8)
    eg = np.zeros((len(idx), 512), np.uint16)
    ev = np.zeros((len(idx), 512), np.int16)
    res, _ = traj.read_frames_b7(idx, space, atom_a, atom_b, pk, eg, ev)
    assert res is not None
    base, inv_b7, b_boxes, _, _ = res
    d = _b7_impl(jnp.asarray(pk), jnp.asarray(eg), jnp.asarray(ev),
                 jnp.asarray(base))
    box = b_boxes[:, [0, 1, 2], [0, 1, 2]].copy()
    mask = np.ones(len(idx), bool)
    step = make_order_step(atom_a, atom_b, btype, bmol, 3, len(heads))
    out, _ = step.impl(d, jnp.asarray(box), jnp.asarray(Z),
                       jnp.asarray(mask), inv_scale=jnp.asarray(inv_b7),
                       diff_input=True)
    pos = c16.astype(np.float64) * np.asarray(inv, np.float64)[:, None, None]
    q, _ = bond_samples(pos, box.astype(np.float64), atom_a, atom_b, Z)
    assert_matches(out["total"], reference_sums(
        q, btype, 3, np.ones(q.shape, np.int64)))


def _inside_cylinder(mid, ref, box, radius):
    rel = min_image64(mid - ref[:, None, :], box[:, None, :])
    r2 = rel[..., 0] ** 2 + rel[..., 1] ** 2
    # the data keeps every midpoint clear of the surface, so f32 and f64
    # agree on every sample
    assert np.abs(r2 - radius ** 2).min() > 1e-4
    return r2 <= radius ** 2


def test_geometry_cylinder_matches_f64():
    from gorder_tpu.core.geometry import build_geometry_spec
    from gorder_tpu.input.config import Geometry

    p = problem(7)
    spec = build_geometry_spec(Geometry("cylinder", reference=(5, 5, 5),
                                        radius=3.0, orientation="z"))
    ref = np.tile(np.array([5, 5, 5], np.float32), (len(p["mask"]), 1))
    step = make_order_step(p["atom_a"], p["atom_b"], p["btype"], p["bmol"],
                           p["T"], p["M"], geom_spec=spec)
    out, _ = step.impl(jnp.asarray(p["coords"]), jnp.asarray(p["box"]),
                       jnp.asarray(Z), jnp.asarray(p["mask"]),
                       geom_ref=jnp.asarray(ref))
    q, mid = bond_samples(p["coords"].astype(np.float64), p["box"],
                          p["atom_a"], p["atom_b"], Z)
    inside = _inside_cylinder(mid, ref.astype(np.float64), p["box"], 3.0)
    w = frame_weight(p, len(p["btype"])) * inside
    assert 0 < w.sum() < frame_weight(p, len(p["btype"])).sum()
    assert_matches(out["total"], reference_sums(q, p["btype"], p["T"], w))


def test_geometry_sphere_quantized_leaflets_match_f64():
    from gorder_tpu.core.geometry import build_geometry_spec
    from gorder_tpu.input.config import Geometry

    p = problem(8)
    spec = build_geometry_spec(Geometry("sphere", reference=(5, 5, 5),
                                        radius=4.0))
    ref = np.tile(np.array([5, 5, 5], np.float32), (len(p["mask"]), 1))
    prec = 500.0
    qc = np.round(p["coords"] * prec).astype(np.int16)
    inv = np.full(len(qc), 1.0 / prec, np.float32)
    classes = p["rng"].integers(0, 2, (len(qc), p["M"])).astype(np.int32)
    step = make_order_step(p["atom_a"], p["atom_b"], p["btype"], p["bmol"],
                           p["T"], p["M"], with_leaflets=True,
                           geom_spec=spec)
    out, _ = step.impl(jnp.asarray(qc), jnp.asarray(p["box"]),
                       jnp.asarray(Z), jnp.asarray(p["mask"]),
                       leaflet_classes=jnp.asarray(classes),
                       inv_scale=jnp.asarray(inv),
                       geom_ref=jnp.asarray(ref))
    q, mid = bond_samples(qc.astype(np.float64) / prec, p["box"],
                          p["atom_a"], p["atom_b"], Z)
    rel = min_image64(mid - 5.0, p["box"][:, None, :].astype(np.float64))
    r2 = np.sum(rel * rel, axis=-1)
    assert np.abs(r2 - 16.0).min() > 1e-4
    w = frame_weight(p, len(p["btype"])) * (r2 <= 16.0)
    cls = classes[:, p["bmol"]]
    for name, weight in (("total", w), ("upper", w * (cls == 0)),
                         ("lower", w * (cls == 1))):
        assert_matches(out[name], reference_sums(q, p["btype"], p["T"],
                                                 weight))


@pytest.mark.parametrize("with_leaflets", [False, True])
def test_frames_mesh_bitwise_identical(with_leaflets):
    """The step on the 8-device frames mesh gives the same integers as on
    one device."""
    from gorder_tpu.parallel import context
    from gorder_tpu.parallel.context import put_const, put_frames

    n_dev = len(jax.devices())
    assert n_dev == 8
    p = problem(3, B=8 * n_dev)
    classes = (p["rng"].random((len(p["mask"]), p["M"])) > 0.5) \
        .astype(np.int32)
    args = (p["atom_a"], p["atom_b"], p["btype"], p["bmol"], p["T"], p["M"])
    single = make_order_step(*args, with_leaflets=with_leaflets)
    o1, _ = single(p["coords"], p["box"], Z, p["mask"],
                   leaflet_classes=classes if with_leaflets else None)
    mesh = context.activate(len(p["mask"]))
    try:
        assert mesh is not None and mesh.devices.size == n_dev
        meshed = make_order_step(*args, with_leaflets=with_leaflets)
        o2, _ = meshed(put_frames(p["coords"]), put_frames(p["box"]),
                       put_const(Z), put_frames(p["mask"]),
                       leaflet_classes=(put_frames(classes)
                                        if with_leaflets else None))
    finally:
        context.deactivate()
    assert set(o1) == set(o2)
    for c in o1:
        np.testing.assert_array_equal(np.asarray(o1[c]), np.asarray(o2[c]))


# ----------------------------------------------------------- limb reduce


@pytest.mark.parametrize("limb", [127.0, -127.0])
def test_limb_reduce_exact_at_ceiling(limb):
    """MAX_EXACT_SAMPLES samples of the largest limb in one type: the
    sums reach 127·2^17 < 2^24 and stay exact."""
    n = MAX_EXACT_SAMPLES
    rows = np.full((1, n), limb, np.float32)
    out = np.asarray(jax.jit(limb_reduce)(
        rows, rows, rows, np.ones((1, n), np.float32),
        np.ones((n, 1), np.float32)))
    want = int(limb) * n
    assert out[0, :3, 0].tolist() == [want, want, want]
    assert out[0, 3, 0] == n
    sums, counts = recombine_limbs(out)
    assert sums[0, 0] == want * (16384 + 128 + 1) and counts[0, 0] == n


def test_limb_reduce_matches_int64():
    rng = np.random.default_rng(4)
    B, N, T = 8, 3000, 40
    limbs = [rng.integers(-127, 128, (B, N)).astype(np.float32)
             for _ in range(3)]
    mask = rng.integers(0, 2, (B, N)).astype(np.float32)
    btype = rng.integers(0, T, N)
    onehot = np.zeros((N, T), np.float32)
    onehot[np.arange(N), btype] = 1.0
    out = np.asarray(jax.jit(limb_reduce)(*limbs, mask, onehot))
    for c, row in enumerate([l * mask for l in limbs] + [mask]):
        want = np.zeros((B, T), np.int64)
        for b in range(B):
            np.add.at(want[b], btype, row[b].astype(np.int64))
        np.testing.assert_array_equal(out[:, c, :].astype(np.int64), want)


# ------------------------------------------------------ united atom


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _rodrigues(v, k, angle):
    c, s = np.cos(angle), np.sin(angle)
    return (v * c + np.cross(k, v) * s
            + k * np.sum(k * v, axis=-1, keepdims=True) * (1.0 - c))


def predict64(cat, t, helpers, box):
    """uaorder.rs:944-1106 virtual hydrogens in float64 (min-image helper
    vectors)."""
    th = [min_image64(h - t, box) for h in helpers]
    if cat == "ch3":
        hv1 = _rodrigues(th[0], _unit(np.cross(th[1], th[0])),
                         float(TETRAHEDRAL_ANGLE))
        axis2 = _unit(th[0])
        hvs = [hv1, _rodrigues(hv1, axis2, float(CH3_ANGLE)),
               _rodrigues(hv1, axis2, -float(CH3_ANGLE))]
    elif cat == "ch2":
        u1, u2 = _unit(th[0]), _unit(th[1])
        axis = _unit(u1 - u2)
        rot = np.cross(np.cross(u2, u1), axis)
        hvs = [_rodrigues(rot, axis, float(TETRAHEDRAL_ANGLE_HALF)),
               _rodrigues(rot, axis, -float(TETRAHEDRAL_ANGLE_HALF))]
    elif cat == "ch1u":
        cos_g = np.sum(th[0] * th[1], axis=-1, keepdims=True) / (
            np.linalg.norm(th[0], axis=-1, keepdims=True)
            * np.linalg.norm(th[1], axis=-1, keepdims=True))
        gamma = np.arccos(np.clip(cos_g, -1.0, 1.0))
        hvs = [_rodrigues(th[1], _unit(np.cross(th[0], th[1])),
                          np.pi - gamma / 2.0)]
    else:
        hvs = [-(_unit(th[0]) + _unit(th[1]) + _unit(th[2]))]
    return [_unit(hv) * float(BOND_LENGTH) for hv in hvs]


def ua_problem(seed, categories, B=16, n_mols=12):
    """Chains of 10 atoms per molecule with one CH3, three CH2, one CH1u
    and one CH1s each; only `categories` are analyzed."""
    rng = np.random.default_rng(seed)
    per = 10
    coords = rng.uniform(0, 6, (B, n_mols * per, 3)).astype(np.float32)
    box = np.full((B, 3), 6.0, np.float32)
    mask = np.ones(B, bool)
    mask[-2:] = False
    layout = {"ch3": [(0, (1, 2))],
              "ch2": [(1, (4, 2)), (2, (1, 3)), (3, (2, 4))],
              "ch1u": [(5, (4, 6))],
              "ch1s": [(7, (6, 8, 9))]}
    n_h = {"ch3": 3, "ch2": 2, "ch1u": 1, "ch1s": 1}
    cats = {}
    btype, bmol = [], []
    for cat in ("ch3", "ch2", "ch1u", "ch1s"):
        if cat not in categories:
            continue
        d = {"target": [], "mol": []}
        for m in range(n_mols):
            for target, helpers in layout[cat]:
                d["target"].append(m * per + target)
                for i, h in enumerate(helpers, 1):
                    d.setdefault(f"h{i}", []).append(m * per + h)
                d["mol"].append(m)
        cats[cat] = {k: np.asarray(v, np.int32) for k, v in d.items()}
        for i in range(len(d["target"])):
            for k in range(n_h[cat]):
                btype.append((i * n_h[cat] + k) % 7)
                bmol.append(d["mol"][i])
    return (coords, box, mask, cats, np.asarray(btype, np.int32),
            np.asarray(bmol, np.int32), 7, n_mols)


def ua_samples64(pos, box, cats, normal):
    """(B, Nv) quantized samples in the step's hydrogen-major layout."""
    parts = []
    b = box[:, None, :]
    for cat in ("ch3", "ch2", "ch1u", "ch1s"):
        if cat not in cats:
            continue
        ix = cats[cat]
        t = pos[:, ix["target"]]
        helpers = [pos[:, ix[f"h{i}"]]
                   for i in (1, 2, 3) if f"h{i}" in ix]
        hvs = predict64(cat, t, helpers, b)
        n = normal if normal.ndim == 1 else normal[:, ix["mol"]]
        per_h = [p2_64(hv, np.broadcast_to(n, hv.shape)) for hv in hvs]
        parts.append(np.stack(per_h, axis=-1).reshape(len(pos), -1))
    return quantize64(np.concatenate(parts, axis=1))


@pytest.mark.parametrize("category", ["ch3", "ch2", "ch1u", "ch1s"])
def test_ua_category_matches_f64(category):
    coords, box, mask, cats, btype, bmol, T, M = ua_problem(0, [category])
    step = make_ua_step(cats, btype, bmol, T)
    out, _ = step(coords, box, Z, mask)
    q = ua_samples64(coords.astype(np.float64), box, cats,
                     Z.astype(np.float64))
    w = np.broadcast_to(mask[:, None], q.shape).astype(np.int64)
    assert_matches(out["total"], reference_sums(q, btype, T, w))


def test_ua_quantized_leaflets_per_molecule_normal_match_f64():
    coords, box, mask, cats, btype, bmol, T, M = ua_problem(
        1, ["ch3", "ch2", "ch1u", "ch1s"])
    rng = np.random.default_rng(2)
    prec = 200.0
    qc = np.round(coords * prec).astype(np.int16)
    inv = np.full(len(qc), 1.0 / prec, np.float32)
    classes = (rng.random((len(qc), M)) > 0.5).astype(np.int32)
    normals = rng.normal(0, 1, (len(qc), M, 3)).astype(np.float32)
    step = make_ua_step(cats, btype, bmol, T, with_leaflets=True,
                        normal_mode="per_molecule")
    out, _ = step(qc, box, normals, mask, leaflet_classes=classes,
                  inv_scale=inv)
    q = ua_samples64(qc.astype(np.float64) / prec, box, cats,
                     normals.astype(np.float64))
    w = np.broadcast_to(mask[:, None], q.shape).astype(np.int64)
    cls = classes[:, bmol]
    for name, weight in (("total", w), ("upper", w * (cls == 0)),
                         ("lower", w * (cls == 1))):
        assert_matches(out[name], reference_sums(q, btype, T, weight))


def test_ua_frames_mesh_bitwise_identical():
    from gorder_tpu.parallel import context
    from gorder_tpu.parallel.context import put_const, put_frames

    n_dev = len(jax.devices())
    coords, box, mask, cats, btype, bmol, T, M = ua_problem(
        5, ["ch3", "ch2", "ch1u", "ch1s"], B=8 * n_dev)
    o1, _ = make_ua_step(cats, btype, bmol, T)(coords, box, Z, mask)
    mesh = context.activate(len(mask))
    try:
        assert mesh is not None and mesh.devices.size == n_dev
        o2, _ = make_ua_step(cats, btype, bmol, T)(
            put_frames(coords), put_frames(box), put_const(Z),
            put_frames(mask))
    finally:
        context.deactivate()
    np.testing.assert_array_equal(np.asarray(o1["total"]),
                                  np.asarray(o2["total"]))


# ------------------------------------------------------------- on the GPU


@pytest.mark.gpu
def test_limb_reduce_exact_on_gpu(gpu):
    n = MAX_EXACT_SAMPLES
    rows = jax.device_put(np.full((1, n), 127.0, np.float32), gpu)
    out = np.asarray(jax.jit(limb_reduce)(
        rows, rows, rows, jax.device_put(np.ones((1, n), np.float32), gpu),
        jax.device_put(np.ones((n, 1), np.float32), gpu)))
    assert out[0, :, 0].tolist() == [127 * n, 127 * n, 127 * n, n]


@pytest.mark.gpu
def test_order_step_gpu_matches_f64(gpu):
    p = problem(0)
    with jax.default_device(gpu):
        step = make_order_step(p["atom_a"], p["atom_b"], p["btype"],
                               p["bmol"], p["T"], p["M"])
        out, _ = step(p["coords"], p["box"], Z, p["mask"])
    q, _ = bond_samples(p["coords"].astype(np.float64), p["box"],
                        p["atom_a"], p["atom_b"], Z)
    assert_matches(out["total"], reference_sums(
        q, p["btype"], p["T"], frame_weight(p, len(p["btype"]))))
