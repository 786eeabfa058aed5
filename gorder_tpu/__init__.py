"""gorder-tpu: accelerator-native lipid order-parameter analysis.

A ground-up JAX/XLA re-architecture with the capability surface of the Rust
`gorder` package (see SURVEY.md): atomistic, coarse-grained and united-atom
order parameters from GROMACS trajectories with leaflet-wise analysis
(8 assignment methods), dynamic membrane normals, 2-D ordermaps, error
estimation, geometric region selection, trajectory concatenation and
YAML/TAB/CSV/XVG output.

Python API::

    import gorder_tpu as gorder

    analysis = gorder.Analysis(
        structure="system.tpr",
        trajectory="traj.xtc",
        analysis_type=gorder.AnalysisType.aaorder(
            "@membrane and element name carbon",
            "@membrane and element name hydrogen"),
        leaflets=gorder.LeafletClassification.global_("@membrane", "name P"),
        output_yaml="order.yaml",
    )
    results = analysis.run()
    results.write()
    for molecule in results.molecules:
        print(molecule.name, molecule.average_order.total.value)
"""

import jax as _jax

# Accelerator matmuls may default to reduced-precision inputs (TF32 on
# NVIDIA tensor cores); the similarity/covariance algebra
# (spectral clustering, PCA normals, leaflet reductions) needs real f32.
# Set at package import so every entry point — kernels used directly as
# well as the full pipeline — computes identically across backends. The
# exact fixed-point limb reductions are integer-exact either way, and
# matmul time is negligible in this workload (docs/PERFORMANCE.md).
try:
    _jax.config.update("jax_default_matmul_precision", "float32")
except Exception:  # pragma: no cover - ancient jax without the option
    pass

from .version import __version__  # noqa: F401
from .errors import (  # noqa: F401
    AnalysisError,
    ConfigError,
    GorderError,
    SelectionError,
    TopologyError,
    WriteError,
)
from .input.config import (  # noqa: F401
    Analysis,
    AnalysisType,
    Collect,
    EstimateError,
    Frequency,
    Geometry,
    GridSpan,
    LeafletClassification,
    MembraneNormal,
    OrderMapParams,
)
from .results.model import (  # noqa: F401
    AnalysisResults,
    AtomResults,
    BondResults,
    MoleculeResults,
    Order,
    OrderCollection,
)

# pygorder-compatible namespaces (gorder.analysis_types.AAOrder, ...)
from .compat import (  # noqa: F401,E402
    analysis_types,
    estimate_error as estimate_error_module,
    exceptions,
    geometry,
    leaflets,
    membrane_normal,
    ordermap,
)

# pygorder spells it `gorder.estimate_error.EstimateError`; the top-level
# EstimateError class import above stays for the native API
estimate_error = estimate_error_module

import sys as _sys  # noqa: E402

_sys.modules[__name__ + ".analysis_types"] = analysis_types
_sys.modules[__name__ + ".estimate_error"] = estimate_error_module
_sys.modules[__name__ + ".leaflets"] = leaflets
_sys.modules[__name__ + ".geometry"] = geometry
_sys.modules[__name__ + ".membrane_normal"] = membrane_normal
_sys.modules[__name__ + ".ordermap"] = ordermap
_sys.modules[__name__ + ".exceptions"] = exceptions
