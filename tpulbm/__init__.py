"""tpulbm — a Lattice Boltzmann framework on JAX.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of
LGMOak/HighPerformanceComputing-LatticeBoltzmannMethod (a hybrid
MPI + OpenMP + AVX2 C++20 D2Q9 solver): same physics, same artifacts, same
analysis scripts — with SoA population-major layout, a fused collide-stream
GPU kernel (Pallas through Triton), `shard_map` + `ppermute` halo exchange
over a 2-D device mesh, and `lax.scan`-chunked time stepping.
"""

from .config import PRESETS, SimulationParams, tau_for_reynolds
from .lattice import D2Q9, D3Q19, LATTICES, Lattice

__version__ = "0.1.0"

__all__ = [
    "PRESETS", "SimulationParams", "tau_for_reynolds",
    "D2Q9", "D3Q19", "LATTICES", "Lattice",
]
