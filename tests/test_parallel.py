"""Multi-chip sharding tests on the 8-device virtual CPU mesh."""

import numpy as np
import jax
import pytest


def test_eight_virtual_devices():
    assert jax.devices()[0].platform == "cpu"
    assert len(jax.devices()) == 8


def test_dryrun_multichip():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).parent.parent / "__graft_entry__.py"
    spec = importlib.util.spec_from_file_location("graft_entry", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    assert np.isfinite(np.asarray(out["total"])).all()

    mod.dryrun_multichip(8)
    mod.dryrun_multichip(4)


def test_frame_sharded_matches_single_device(fixtures):
    """Device-count invariance: the order kernel gives bit-identical sums
    whether the batch is on one device or sharded over eight."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gorder_tpu.core.order import make_order_step
    from gorder_tpu.parallel import frame_mesh

    rng = np.random.default_rng(1)
    n_atoms, n_bonds, n_types, n_mols = 512, 256, 16, 32
    atom_a = rng.integers(0, n_atoms, n_bonds)
    atom_b = (atom_a + 1) % n_atoms
    bond_type = rng.integers(0, n_types, n_bonds)
    bond_mol = rng.integers(0, n_mols, n_bonds)

    step = make_order_step(atom_a, atom_b, bond_type, bond_mol,
                           n_types, n_mols, with_leaflets=True)

    B = 16
    coords = rng.random((B, n_atoms, 3), np.float32) * 10.0
    box = np.tile(np.array([10.0, 10.0, 10.0], np.float32), (B, 1))
    mask = np.ones(B, bool)
    normal = np.array([0, 0, 1], np.float32)
    classes = rng.integers(0, 2, (B, n_mols)).astype(np.int32)

    single_out, _ = step(coords, box, normal, mask, classes)
    single = {k: np.asarray(v) for k, v in single_out.items()}

    mesh = frame_mesh()
    sh = NamedSharding(mesh, P("frames"))
    sharded_out, _ = step(
        jax.device_put(coords, sh), jax.device_put(box, sh),
        jax.device_put(normal, NamedSharding(mesh, P())),
        jax.device_put(mask, sh), jax.device_put(classes, sh),
    )
    sharded = {k: np.asarray(v) for k, v in sharded_out.items()}

    for key in single:
        np.testing.assert_array_equal(single[key], sharded[key])
