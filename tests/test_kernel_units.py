"""Tier-1 numeric unit tests against hand values (SURVEY §4 tier 1:
calc_sch hand value from src/analysis/mod.rs:94-105, PCA normals from
synthetic planes from normal.rs:577-641, fixed-point quantization)."""

import numpy as np

from gorder_tpu.core.order import make_order_step


def _run_single_bond(pa, pb, box, normal):
    """One frame, one bond through the production kernel → S value."""
    coords = np.zeros((8, 2, 3), np.float32)  # batch padded to 8
    coords[0, 0] = pa
    coords[0, 1] = pb
    boxes = np.tile(np.asarray(box, np.float32), (8, 1))
    mask = np.zeros(8, bool)
    mask[0] = True
    step = make_order_step(np.array([0], np.int32), np.array([1], np.int32),
                           np.array([0], np.int32), np.array([0], np.int32),
                           1, 1)
    out, _ = step(coords, boxes, np.asarray(normal, np.float32), mask)
    arr = np.asarray(out["total"])
    from gorder_tpu.core.order import recombine_limbs

    sums, counts = recombine_limbs(arr)
    assert counts.sum() == 1
    return int(sums.sum())  # 1e-6 quanta


def test_calc_sch_hand_value():
    """mod.rs test_calc_sch: P2 of the min-image vector (1.7,2.1,9.7)→
    (1.9,2.4,0.8) in a 10 nm box against +z is 0.8544775."""
    q = _run_single_bond([1.7, 2.1, 9.7], [1.9, 2.4, 0.8],
                         [10.0, 10.0, 10.0], [0.0, 0.0, 1.0])
    # production kernel rounds to the 1e-6 fixed-point grid
    assert abs(q - 854477.5) <= 1.0


def test_calc_sch_axis_aligned():
    """A bond parallel to the normal → S = 1; perpendicular → S = -0.5."""
    q = _run_single_bond([1, 1, 1], [1, 1, 2], [10, 10, 10], [0, 0, 1])
    assert q == 1_000_000
    q = _run_single_bond([1, 1, 1], [2, 1, 1], [10, 10, 10], [0, 0, 1])
    assert q == -500_000


def test_magic_angle():
    """At the magic angle (cos² = 1/3) the order parameter vanishes."""
    d = np.array([1.0, 1.0, 1.0], np.float32)  # cos²(z) = 1/3
    q = _run_single_bond([0, 0, 0], d, [50, 50, 50], [0, 0, 1])
    assert abs(q) <= 10


def test_pca_normal_from_synthetic_plane():
    """normal.rs:577-641 analogue: heads scattered on a tilted plane →
    the dynamic-normal PCA recovers the plane normal."""
    from gorder_tpu.core.normals import make_dynamic_normals

    rng = np.random.default_rng(7)
    n_heads = 64
    # plane with normal ∝ (1, 2, 2) through (5, 5, 5)
    normal = np.array([1.0, 2.0, 2.0]) / 3.0
    u = np.array([2.0, -1.0, 0.0]) / np.sqrt(5.0)
    v = np.cross(normal, u)
    ab = rng.uniform(-1.5, 1.5, (n_heads, 2))
    pts = 5.0 + ab[:, :1] * u + ab[:, 1:] * v
    coords = np.zeros((1, n_heads, 3), np.float32)
    coords[0] = pts
    box = np.full((1, 3), 50.0, np.float32)

    compute = make_dynamic_normals(
        head_indices=np.arange(n_heads, dtype=np.int32),
        cloud_indices=np.arange(n_heads, dtype=np.int32),
        radius=10.0)
    normals, counts = compute(coords, box)
    got = np.asarray(normals)[0]
    assert np.asarray(counts).min() >= 3
    cos = np.abs(got @ normal)  # sign ambiguity
    assert np.all(cos > 0.9999), cos.min()


def test_fixed_point_rounding_matches_reference_rule():
    """order.rs:21-26: OrderValue::from is `(v * 1e6).round()` — round half
    away from zero, NOT truncation."""
    q = _run_single_bond([0, 0, 0], [3.0, 0.0, 4.0], [50, 50, 50],
                         [0, 0, 1])
    # cos² = 16/25 → s = 1.5·0.64 − 0.5 = 0.46; 0.64 is not exactly
    # representable in f32 and the product lands a hair below 460000 —
    # rounding (the reference rule) recovers exactly 460000, where
    # truncation toward zero would have kept 459999.
    assert q == 460_000


def test_leaflet_head_methyl_resolution_hand_values(fixtures):
    """leaflets.rs:1604-1688 classifier-construction tests: the head and
    methyl atom indices resolved for the molecules containing resid
    7 / 144 / 264 of pcpepg.tpr."""
    from gorder_tpu.io.tpr import read_tpr
    from gorder_tpu.select import select_mask

    system = read_tpr(str(fixtures / "pcpepg.tpr"))
    p_mask = select_mask(system, "name P")
    methyl_mask = select_mask(system, "name C218 C316")
    heads, methyls = [], []
    for resid in (7, 144, 264):
        mol = select_mask(system, f"resid {resid}")
        heads.append(int(np.nonzero(p_mask & mol)[0][0]))
        methyls.append(np.nonzero(methyl_mask & mol)[0].tolist())
    assert heads == [760, 18002, 34047]
    assert methyls == [[828, 871], [18070, 18113], [34115, 34158]]


def test_leaflet_assignment_hand_values(fixtures):
    """leaflets.rs:1859-1961 assign_to_leaflet tests: on the pcpepg.tpr
    snapshot, head atom 1385 sits in the upper leaflet and 11885 in the
    lower one under all three geometric classifiers."""
    from gorder_tpu.core.leaflets import (
        make_global_classifier,
        make_individual_classifier,
        make_local_classifier,
    )
    from gorder_tpu.io.tpr import read_tpr
    from gorder_tpu.select import select_mask

    system = read_tpr(str(fixtures / "pcpepg.tpr"))
    coords = system.positions[None]
    box = np.diag(system.box).astype(np.float32)[None]
    membrane = np.nonzero(select_mask(system, "@membrane"))[0]
    heads = np.array([1385, 11885])

    classify = make_global_classifier(membrane, heads, 2)
    np.testing.assert_array_equal(np.asarray(classify(coords, box))[0],
                                  [0, 1])

    classify = make_local_classifier(membrane, heads, 2, 2.5)
    np.testing.assert_array_equal(np.asarray(classify(coords, box))[0],
                                  [0, 1])

    classify = make_individual_classifier(
        heads, np.array([1453, 1496, 11953, 11996]),
        np.array([0, 0, 1, 1]), 2, 2)
    np.testing.assert_array_equal(np.asarray(classify(coords, box))[0],
                                  [0, 1])


def test_ua_hydrogen_prediction_hand_values(fixtures):
    """buildH virtual-hydrogen positions vs the reference's unit-test hand
    values on the ua.tpr snapshot (uaorder.rs:1114-1201)."""
    import jax.numpy as jnp

    from gorder_tpu.core.ua import (
        predict_ch1_saturated,
        predict_ch1_unsaturated,
        predict_ch2,
        predict_ch3,
    )
    from gorder_tpu.io.tpr import read_tpr

    system = read_tpr(str(fixtures / "ua.tpr"))
    pos = jnp.asarray(system.positions[None, None, :, :])  # (1, 1, A, 3)

    def p(i):
        return pos[:, :, i, :]

    box = jnp.asarray(np.diag(system.box), np.float32)[None, None, :]

    def check(hydrogens, expected):
        got = np.stack([np.asarray(h)[0, 0] for h in hydrogens])
        np.testing.assert_allclose(got, np.asarray(expected, np.float64),
                                   rtol=2e-5, atol=2e-6)

    # CH2: helper1=38, target=39, helper2=40
    check(predict_ch2(p(39), p(38), p(40), box, True),
          [[2.3435528, 2.1503785, 2.1272178],
           [2.35857, 2.3045487, 2.039533]])
    # CH3: helper1=48, target=49, helper2=47
    check(predict_ch3(p(49), p(48), p(47), box, True),
          [[3.3708375, 2.7527616, 2.257202],
           [3.254057, 2.8633823, 2.3334126],
           [3.3182635, 2.8995805, 2.1713943]])
    # CH1 unsaturated: helper1=22, target=23, helper2=24
    check(predict_ch1_unsaturated(p(23), p(22), p(24), box, True),
          [[1.0985602, 2.994375, 2.7727659]])
    # CH1 saturated: helpers 11/31/13, target 12
    check(predict_ch1_saturated(p(12), p(11), p(31), p(13), box, True),
          [[1.5022101, 2.6938448, 1.7839708]])


def test_ua_planar_predictors_bit_match_vector_forms():
    """The planar (structure-of-arrays) predictors — the production UA
    path — must be BIT-identical to the vector
    reference formulation: same f32 operations in the same order
    (core/ua.py planar block)."""
    import jax.numpy as jnp

    from gorder_tpu.core.ua import (
        predict_ch1_saturated, predict_ch1_saturated_planar,
        predict_ch1_unsaturated, predict_ch1_unsaturated_planar,
        predict_ch2, predict_ch2_planar,
        predict_ch3, predict_ch3_planar,
    )

    rng = np.random.default_rng(11)
    B, n = 3, 257
    box = np.asarray(rng.uniform(4.0, 9.0, (B, 1, 3)), np.float32)
    pts = [np.asarray(rng.uniform(-2.0, 11.0, (B, n, 3)), np.float32)
           for _ in range(4)]
    t, h1, h2, h3 = (jnp.asarray(p) for p in pts)
    boxv = jnp.asarray(box)
    tp, h1p, h2p, h3p = (tuple(p[..., i] for i in range(3))
                         for p in (t, h1, h2, h3))
    boxp = tuple(boxv[:, :, i] for i in range(3))

    for handle_pbc in (True, False):
        cases = [
            (predict_ch3(t, h1, h2, boxv, handle_pbc),
             predict_ch3_planar(tp, h1p, h2p, boxp, handle_pbc)),
            (predict_ch2(t, h1, h2, boxv, handle_pbc),
             predict_ch2_planar(tp, h1p, h2p, boxp, handle_pbc)),
            (predict_ch1_unsaturated(t, h1, h2, boxv, handle_pbc),
             predict_ch1_unsaturated_planar(tp, h1p, h2p, boxp,
                                            handle_pbc)),
            (predict_ch1_saturated(t, h1, h2, h3, boxv, handle_pbc),
             predict_ch1_saturated_planar(tp, h1p, h2p, h3p, boxp,
                                          handle_pbc)),
        ]
        for vec_out, pl_out in cases:
            assert len(vec_out) == len(pl_out)
            for hv, hp in zip(vec_out, pl_out):
                got = np.stack([np.asarray(c) for c in hp], axis=-1)
                np.testing.assert_array_equal(np.asarray(hv), got)


def test_quantize_matches_f64_reference_rule_brute_force():
    """quantize_split reproduces the reference's f64 quantization
    (order.rs:21-26: round(v as f64 * 1e6) half away from zero) bit for
    bit, via the error-free two-product — including exact .5 ties and
    products whose f32 rounding lands on the wrong side of the
    boundary."""
    import jax
    import numpy as np

    from gorder_tpu.core.order import _LIMB, _LIMB2, quantize_split

    def ref_q(v):
        x = np.float64(v) * 1e6
        return np.trunc(x + np.where(x >= 0, 0.5, -0.5))

    qs = jax.jit(quantize_split)
    rng = np.random.default_rng(12345)
    n = 200_000
    cases = [
        rng.uniform(-0.5, 1.0, n).astype(np.float32),
        # exact .5-quantum boundaries and their f32 neighbours
        ((rng.integers(-500000, 1000000, n) + 0.5) / 1e6).astype(np.float32),
        np.nextafter(((rng.integers(-500000, 1000000, n) + 0.5)
                      / 1e6).astype(np.float32), np.inf),
        rng.uniform(-1e-3, 1e-3, n).astype(np.float32),
        np.float32([0.8544775, -0.8544775, 0.46, 5e-7, -5e-7, 0.0]),
    ]
    for v in cases:
        l2, l1, l0 = qs(v)
        got = (np.asarray(l2, np.float64) * _LIMB2
               + np.asarray(l1, np.float64) * _LIMB
               + np.asarray(l0, np.float64))
        np.testing.assert_array_equal(got, ref_q(v))
