"""Lattice descriptors (D2Q9, D3Q19).

The equivalent of the reference's compile-time lattice constants
(reference: include/LBMConfig.h:9-34 — Q, D, VELOCITIES, WEIGHTS, OPPOSITE).

We keep the *exact same direction ordering* as the reference so every piece of
boundary-condition algebra (Zou-He, wall bounce-back) carries over index-for-index:

    D2Q9:  0:( 0, 0)  1:( 1, 0)  2:( 0, 1)  3:(-1, 0)  4:( 0,-1)
           5:( 1, 1)  6:(-1, 1)  7:(-1,-1)  8:( 1,-1)

Constants live as NumPy arrays; kernels bake them in as compile-time constants
(they are tiny), so nothing here ever becomes a traced value.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np


@dataclasses.dataclass(frozen=True)
class Lattice:
    """A DdQq lattice: velocity set, quadrature weights, and opposite map."""

    name: str
    D: int
    velocities: tuple[tuple[int, ...], ...]  # (Q, D) integer lattice velocities
    weights: tuple[float, ...]               # (Q,) quadrature weights

    @property
    def Q(self) -> int:
        return len(self.velocities)

    @cached_property
    def c(self) -> np.ndarray:
        """Velocity set as an int (Q, D) array."""
        return np.asarray(self.velocities, dtype=np.int32)

    @cached_property
    def w(self) -> np.ndarray:
        """Weights as a float64 (Q,) array."""
        return np.asarray(self.weights, dtype=np.float64)

    @cached_property
    def opposite(self) -> np.ndarray:
        """opposite[i] = index j with c[j] == -c[i].

        Derived rather than hard-coded; for D2Q9 this reproduces the
        reference's OPPOSITE = {0,3,4,1,2,7,8,5,6} (LBMConfig.h:34).
        """
        c = self.c
        opp = np.empty(self.Q, dtype=np.int32)
        for i in range(self.Q):
            matches = np.where((c == -c[i]).all(axis=1))[0]
            if len(matches) != 1:
                raise ValueError(f"lattice {self.name}: no unique opposite for dir {i}")
            opp[i] = matches[0]
        return opp

    @property
    def cs2(self) -> float:
        """Lattice speed of sound squared (1/3 for the standard lattices here)."""
        return 1.0 / 3.0


# D2Q9 — same ordering as reference LBMConfig.h:13-25, weights LBMConfig.h:28-31.
D2Q9 = Lattice(
    name="D2Q9",
    D=2,
    velocities=(
        (0, 0),
        (1, 0), (0, 1), (-1, 0), (0, -1),
        (1, 1), (-1, 1), (-1, -1), (1, -1),
    ),
    weights=(
        4.0 / 9.0,
        1.0 / 9.0, 1.0 / 9.0, 1.0 / 9.0, 1.0 / 9.0,
        1.0 / 36.0, 1.0 / 36.0, 1.0 / 36.0, 1.0 / 36.0,
    ),
)

# D2Q5 — advection-diffusion lattice for the thermal (double-population)
# models (new capability; the reference is isothermal only). Same first-five
# direction ordering as D2Q9 so index algebra carries over.
D2Q5 = Lattice(
    name="D2Q5",
    D=2,
    velocities=((0, 0), (1, 0), (0, 1), (-1, 0), (0, -1)),
    weights=(1.0 / 3.0, 1.0 / 6.0, 1.0 / 6.0, 1.0 / 6.0, 1.0 / 6.0),
)

# D3Q19 — standard lattice (new capability; the reference is 2-D only).
# Ordering: rest, 6 axis-aligned, 12 face-diagonal.
_D3Q19_AXIS = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1))
_D3Q19_DIAG = (
    (1, 1, 0), (-1, -1, 0), (1, -1, 0), (-1, 1, 0),
    (1, 0, 1), (-1, 0, -1), (1, 0, -1), (-1, 0, 1),
    (0, 1, 1), (0, -1, -1), (0, 1, -1), (0, -1, 1),
)
D3Q19 = Lattice(
    name="D3Q19",
    D=3,
    velocities=((0, 0, 0),) + _D3Q19_AXIS + _D3Q19_DIAG,
    weights=(1.0 / 3.0,) + (1.0 / 18.0,) * 6 + (1.0 / 36.0,) * 12,
)

# D3Q27 — the full fourth-order-isotropic 3-D lattice (new capability; the
# reference is 2-D only). Better rotational isotropy than D3Q19 — the
# standard choice for high-fidelity turbulence where D3Q19's missing
# corner links show as grid-aligned artifacts. Ordering: rest, the D3Q19
# set (axis + face-diagonal, index-for-index so shared BC algebra carries
# over), then the 8 corner links.
_D3Q27_CORNER = (
    (1, 1, 1), (-1, -1, -1), (1, 1, -1), (-1, -1, 1),
    (1, -1, 1), (-1, 1, -1), (1, -1, -1), (-1, 1, 1),
)
D3Q27 = Lattice(
    name="D3Q27",
    D=3,
    velocities=((0, 0, 0),) + _D3Q19_AXIS + _D3Q19_DIAG + _D3Q27_CORNER,
    weights=(8.0 / 27.0,) + (2.0 / 27.0,) * 6 + (1.0 / 54.0,) * 12
            + (1.0 / 216.0,) * 8,
)

LATTICES: dict[str, Lattice] = {"D2Q9": D2Q9, "D2Q5": D2Q5, "D3Q19": D3Q19,
                                "D3Q27": D3Q27}
