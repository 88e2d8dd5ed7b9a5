"""Pure physics kernels: moments, equilibrium, BGK collision, Guo forcing.

Equivalents of the reference's math layer:
  * equilibrium       ← LBMUtils.h:9-12 (scalar) / 22-65 (AVX2 SIMD) — here a
                        single vectorized jnp expression over all Q directions
                        at once (no per-lane code).
  * forced equilibrium← LBMUtils.h:15-19, 68-121 (dead code in the reference;
                        live here — it drives the Poiseuille preset).
  * moments + BGK     ← LBMSolver.h:101-123 (the collision hot loop).

All functions are shape-polymorphic over the spatial dims: `f` is
(Q, *spatial) in SoA/population-major layout (x is the minor, contiguous
axis). The reference's storage is actually cell-major AoS
(LBMGrid.h:105-107) despite its README claiming SoA; we use true SoA.

Everything is dtype-polymorphic; lattice constants are baked in as
compile-time constants.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .lattice import Lattice


def _wshape(lat: Lattice, ndim_spatial: int) -> tuple[int, ...]:
    return (lat.Q,) + (1,) * ndim_spatial


def moments(lat: Lattice, f: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Macroscopic density and velocity: rho = Σ_i f_i, u = Σ_i c_i f_i / rho.

    Parity: LBMSolver.h:101-109. Returns (rho: (*spatial,), u: (D, *spatial)).

    Written as explicit ±plane sums, NOT einsum: an einsum lowers to a
    matrix product, which at default precision may run in reduced
    precision (TF32 on a GPU), silently costing ~3 decimal digits per step;
    the velocity components are 0/±1 so exact adds are both correct and
    cheaper.
    """
    rho = jnp.sum(f, axis=0)
    c = lat.c  # (Q, D) host ints
    comps = []
    for d in range(lat.D):
        acc = None
        for i in range(lat.Q):
            cid = int(c[i, d])
            if cid == 0:
                continue
            term = f[i] if cid > 0 else -f[i]
            acc = term if acc is None else acc + term
        comps.append(acc)
    return rho, jnp.stack(comps) / rho


def equilibrium(lat: Lattice, rho: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
    """BGK second-order equilibrium.

    f_eq_i = w_i * rho * (1 + 3 c_i·u + 4.5 (c_i·u)^2 - 1.5 u·u)
    Parity: LBMSolver.h:117-121 and LBMUtils.h:9-12.
    """
    dtype = rho.dtype
    c = lat.c                                    # (Q, D) host ints
    usq = jnp.sum(u * u, axis=0)                 # (*spatial,)
    base = 1.0 - 1.5 * usq
    planes = []
    for i in range(lat.Q):
        # c·u as exact ±adds (see moments() for why not einsum)
        cu = None
        for d in range(lat.D):
            cid = int(c[i, d])
            if cid == 0:
                continue
            term = u[d] if cid > 0 else -u[d]
            cu = term if cu is None else cu + term
        if cu is None:
            planes.append(lat.w[i] * rho * base)
        else:
            planes.append(lat.w[i] * rho * (base + 3.0 * cu + 4.5 * cu * cu))
    return jnp.stack(planes).astype(dtype)


def equilibrium_with_force(lat: Lattice, rho: jnp.ndarray, u: jnp.ndarray,
                           force: tuple[float, ...]) -> jnp.ndarray:
    """Equilibrium plus the reference's simplified Guo forcing term
    +3 w_i (c_i · F) (LBMUtils.h:15-19 — dead code there, live here)."""
    dtype = rho.dtype
    feq = equilibrium(lat, rho, u)
    c = lat.c.astype(np.float64)                 # (Q, D), host-side
    F = np.asarray(force, dtype=np.float64)
    cF = np.asarray(3.0 * lat.w * (c @ F))       # (Q,) host constant
    return feq + jnp.asarray(cF, dtype).reshape(_wshape(lat, rho.ndim))


def collide(lat: Lattice, f: jnp.ndarray, inv_tau: float,
            force: tuple[float, ...] = ()) -> jnp.ndarray:
    """BGK relaxation: f_post = f - (1/tau) (f - f_eq).  Parity: LBMSolver.h:117-123.

    Returns the post-collision populations; pointwise, so it is safe to apply
    on halo cells too (used by the sharded XLA step, which collides the
    padded block so neighbors' post-collision edge values never travel).

    Body force: the source S_i = 3 w_i (c_i · F) is added *post-relaxation*,
    which injects exactly momentum F per step (Σ_i c_i S_i = F by lattice
    isotropy). The reference's dead-code variant folds the same term into the
    equilibrium (LBMUtils.h:15-19), which relaxation scales to an effective
    force F/tau — a tau-dependent bug we deliberately do not reproduce (that
    code never runs in the reference anyway); `equilibrium_with_force`
    preserves the literal formula for parity reference.
    """
    rho, u = moments(lat, f)
    feq = equilibrium(lat, rho, u)
    f_post = f - inv_tau * (f - feq)
    if force:
        c = lat.c.astype(np.float64)
        F = np.asarray(force, dtype=np.float64)
        src = np.asarray(3.0 * lat.w * (c @ F))  # (Q,) host constant
        f_post = f_post + jnp.asarray(src, f.dtype).reshape(_wshape(lat, rho.ndim))
    return f_post


def omega_minus_trt(inv_tau: float, magic: float = 3.0 / 16.0) -> float:
    """Odd-moment relaxation rate for TRT given the viscosity rate 1/tau and
    the 'magic parameter' Λ = (1/ω+ − ½)(1/ω− − ½). Λ = 3/16 places
    bounce-back walls exactly halfway along links and is the standard
    stability-optimal choice."""
    lam_plus = 1.0 / inv_tau - 0.5
    lam_minus = magic / lam_plus
    return 1.0 / (lam_minus + 0.5)


def collide_trt(lat: Lattice, f: jnp.ndarray, inv_tau: float,
                force: tuple[float, ...] = (),
                magic: float = 3.0 / 16.0) -> jnp.ndarray:
    """Two-relaxation-time collision (new capability — the reference is
    BGK-only). Even population parts f⁺ relax at 1/tau (sets viscosity, same
    as BGK); odd parts f⁻ relax at ω⁻ from the magic parameter. Markedly
    more stable than BGK as tau → 1/2 and degenerates to BGK when ω⁻ = 1/tau
    (Λ = λ⁺²).

        f_post = f − ω⁺ (f⁺ − feq⁺) − ω⁻ (f⁻ − feq⁻),
        g±_i = (g_i ± g_opp(i)) / 2.

    Caveat for the reference-parity boundary chain (same mechanism as the
    MRT ghost-rate note below): Λ = 3/16 sends ω⁻ → 0 as tau → 1/2
    (ω⁻ = 0.186 at tau = 0.5384, Re = 200 bench defaults), and the heavily
    under-relaxed odd modes amplify the Zou-He corner re-injection loop —
    measured blow-up by t = 800 on 512×128 f32. `zou_he_corners="clean"`
    removes the loop and is measured stable at the same tau; with clean
    corners TRT delivers its tau → 1/2 stability advantage as advertised.
    """
    rho, u = moments(lat, f)
    feq = equilibrium(lat, rho, u)
    opp = tuple(int(v) for v in lat.opposite)
    f_o = f[jnp.array(opp)]
    feq_o = feq[jnp.array(opp)]
    omega_p = inv_tau
    omega_m = omega_minus_trt(inv_tau, magic)
    # f - ω+ (f+ - feq+) - ω- (f- - feq-), with g± = (g ± g_opp)/2
    half_p = 0.5 * omega_p
    half_m = 0.5 * omega_m
    f_post = (f
              - half_p * ((f + f_o) - (feq + feq_o))
              - half_m * ((f - f_o) - (feq - feq_o)))
    if force:
        c = lat.c.astype(np.float64)
        F = np.asarray(force, dtype=np.float64)
        src = np.asarray(3.0 * lat.w * (c @ F))
        f_post = f_post + jnp.asarray(src, f.dtype).reshape(_wshape(lat, rho.ndim))
    return f_post


def collide_regularized(lat: Lattice, f: jnp.ndarray, inv_tau: float,
                        force: tuple[float, ...] = ()) -> jnp.ndarray:
    """Regularized BGK (Latt & Chopard 2006; new capability — the
    reference is plain BGK). Before relaxing, the non-equilibrium part is
    PROJECTED onto its second-order Hermite shell — the only part with
    hydrodynamic content:

        Π^neq_αβ = Σ_i c_iα c_iβ (f_i − feq_i)
        fneq_reg_i = (9/2) w_i Q_iαβ Π^neq_αβ,  Q_i = c_i c_i − I/3
        f_post = feq + (1 − 1/τ) fneq_reg   (+ the usual source term)

    Ghost-mode noise (everything outside the shell) is discarded every
    step instead of relaxing at 1/τ, which markedly extends the stable
    range at low τ / coarse resolution while leaving the viscosity
    exactly (τ − ½)/3. Idempotent: a state whose fneq already lies in the
    shell collides exactly like BGK (gated). Lattice-generic (D2Q9,
    D3Q19, D3Q27)."""
    rho, u = moments(lat, f)
    feq = equilibrium(lat, rho, u)
    fneq = f - feq
    c = lat.c.astype(np.float64)                 # (Q, D) host
    D = lat.D
    ndim = rho.ndim
    # Σ_αβ Q_iαβ Π_αβ = Σ_α (c_iα² − 1/3) Π_αα + 2 Σ_{α<β} c_iα c_iβ Π_αβ
    proj = 0.0
    pairs = [(a, a) for a in range(D)] + [(a, b) for a in range(D)
                                          for b in range(a + 1, D)]
    for a, b in pairs:
        cab = c[:, a] * c[:, b]                  # (Q,) host
        # precision=HIGHEST: a default-precision tensordot may run in
        # reduced precision (TF32 on a GPU; see moments())
        pi_ab = jnp.tensordot(jnp.asarray(cab, f.dtype), fneq, axes=(0, 0),
                              precision=jax.lax.Precision.HIGHEST)
        coeff = cab - (1.0 / 3.0 if a == b else 0.0)
        if a != b:
            coeff = 2.0 * coeff
        wq = np.asarray(4.5 * lat.w * coeff)     # (Q,) host
        proj = proj + jnp.asarray(wq, f.dtype).reshape(
            _wshape(lat, ndim)) * pi_ab[None]
    f_post = feq + (1.0 - inv_tau) * proj
    if force:
        F = np.asarray(force, dtype=np.float64)
        src = np.asarray(3.0 * lat.w * (c @ F))
        f_post = f_post + jnp.asarray(src, f.dtype).reshape(
            _wshape(lat, ndim))
    return f_post


def kbc_projectors(lat: Lattice) -> tuple[np.ndarray, np.ndarray]:
    """(S, H) population-space projectors for the D2Q9 KBC entropic
    multi-relaxation operator (Bösch, Chikatamarla & Karlin 2015, the
    natural-moment N-type model; new capability — the reference is plain
    BGK). The nine monomial moments m_pq = Σ_i c_ix^p c_iy^q f_i split
    into kinematic (ρ, j — conserved, untouched), shear
    s = {Π_xy, N = Π_xx − Π_yy} (relaxed at 2β = 1/τ, fixing the shear
    viscosity at exactly (τ − ½)/3), and higher-order
    h = {T = Π_xx + Π_yy, q_xyy, q_yxx, A_xxyy} (relaxed at the
    per-cell entropic rate βγ). S and H are exact complementary
    projectors on the non-conserved subspace: S + H restricted to
    Δf = f − feq is the identity (Δρ = Δj = 0)."""
    if lat.D != 2 or lat.Q != 9:
        raise ValueError("the KBC operator is implemented for D2Q9")
    c = lat.c.astype(np.float64)
    mons = [(0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (0, 2),
            (1, 2), (2, 1), (2, 2)]
    M = np.stack([c[:, 0] ** p * c[:, 1] ** q for p, q in mons])  # (9, Q)
    Minv = np.linalg.inv(M)
    Ps = np.zeros((9, 9))
    Ps[3, 3] = 1.0                      # Π_xy
    # N-part of the (Π_xx, Π_yy) subspace: (Δxx − Δyy)/2 · (±1)
    Ps[4, 4] = Ps[5, 5] = 0.5
    Ps[4, 5] = Ps[5, 4] = -0.5
    Ph = np.zeros((9, 9))
    for k in (6, 7, 8):                 # q_xyy, q_yxx, A_xxyy
        Ph[k, k] = 1.0
    # T-part (trace) of the (Π_xx, Π_yy) subspace
    Ph[4, 4] = Ph[5, 5] = Ph[4, 4] + 0.5
    Ph[4, 5] = Ph[5, 4] = 0.5
    S = Minv @ Ps @ M
    H = Minv @ Ph @ M
    return S, H


def collide_kbc(lat: Lattice, f: jnp.ndarray, inv_tau: float,
                force: tuple[float, ...] = ()) -> jnp.ndarray:
    """KBC entropic multi-relaxation collision (D2Q9):

        f' = f − 2β·Δs − β·γ·Δh,   β = 1/(2τ)

    with the stabilizer γ chosen PER CELL to maximize the post-collision
    entropy (the closed-form estimate of Bösch et al. 2015):

        γ = 1/β − (2 − 1/β) · ⟨Δs|Δh⟩ / ⟨Δh|Δh⟩,
        ⟨x|y⟩ = Σ_i x_i y_i / feq_i.

    At γ = 2 (the value taken wherever ⟨Δh|Δh⟩ vanishes, and the
    equilibrium limit) the operator reduces EXACTLY to BGK; the shear
    part always relaxes at 1/τ, so ν = (τ − ½)/3 unchanged. Away from
    equilibrium γ adapts to damp ghost modes entropically — the
    stability of regularized BGK without discarding the higher moments
    wholesale."""
    rho, u = moments(lat, f)
    feq = equilibrium(lat, rho, u)
    dneq = f - feq
    S, H = kbc_projectors(lat)
    # precision=HIGHEST: at default precision these 9×9 projector
    # contractions may run in reduced precision (TF32 on a GPU), planting
    # ~1e-3 relative noise in ds/dh that the sh/hh entropic ratio then
    # amplifies. HIGHEST keeps the contraction in f32 like moments() does.
    ds = jnp.tensordot(jnp.asarray(S, f.dtype), dneq, axes=(1, 0),
                       precision=jax.lax.Precision.HIGHEST)
    dh = jnp.tensordot(jnp.asarray(H, f.dtype), dneq, axes=(1, 0),
                       precision=jax.lax.Precision.HIGHEST)
    inv_feq = 1.0 / feq
    sh = jnp.sum(ds * dh * inv_feq, axis=0)
    hh = jnp.sum(dh * dh * inv_feq, axis=0)
    beta = 0.5 * inv_tau
    # Tikhonov-regularized entropic estimate: γ = 1/β − (2−1/β)·sh/(hh+λ).
    # The raw sh/hh ratio is catastrophically ill-conditioned whenever the
    # higher-mode deviation dh is rounding noise while the shear deviation
    # ds is real: |sh| ≤ √(ss·hh) (Cauchy–Schwarz), so γ·dh = O(ds) with a
    # NOISE-DIRECTION-dependent sign — measured as a 1000×/step
    # amplification of fma rounding differences between two
    # implementations (a hard hh-threshold guard does not help: flips just
    # move to the threshold). With the λ floor the worst-case damage of an
    # O(eps) input perturbation is O(eps·√(ss·feq)) — true roundoff — while
    # resolved physics (hh ≫ λ) sees γ to ≤1% at hh = 100λ. λ sits ~5
    # decades below resolved-turbulence hh (~1e-5·rho) and ~5 above the
    # f32 rounding floor of hh (~1e-15).
    lam = 1e-20 if f.dtype == jnp.float64 else 1e-10
    gamma = 1.0 / beta - (2.0 - 1.0 / beta) * sh / (hh + lam)
    f_post = f - (2.0 * beta) * ds - (beta * gamma)[None] * dh
    if force:
        c = lat.c.astype(np.float64)
        F = np.asarray(force, dtype=np.float64)
        src = np.asarray(3.0 * lat.w * (c @ F))
        f_post = f_post + jnp.asarray(src, f.dtype).reshape(
            _wshape(lat, rho.ndim))
    return f_post


def _mrt_basis(lat: Lattice) -> tuple[np.ndarray, tuple[str, ...]]:
    """Moment matrix M (Q, Q) and per-row moment names for the MRT
    (multiple-relaxation-time) operator, built programmatically from the
    lattice velocity set via the standard orthogonal polynomial bases:

      * D2Q9  — Lallemand & Luo (2000): (rho, e, eps, jx, qx, jy, qy,
        pxx, pxy); reproduces the usual integer matrix.
      * D3Q19 — d'Humieres et al. (2002): (rho, e, eps, jx, qx, jy, qy,
        jz, qz, pxx, pixx, pww, piww, pxy, pyz, pxz, mx, my, mz).

    Rows are mutually orthogonal under the uniform inner product
    (M @ M.T is diagonal — asserted), which is what makes the inverse
    well-conditioned. The operator itself only requires invertibility;
    orthogonality is the canonical choice.
    """
    c = lat.c.astype(np.float64)                     # (Q, D)
    cx, cy = c[:, 0], c[:, 1]
    if lat.D == 2:
        c2 = cx * cx + cy * cy
        rows = [
            ("rho", np.ones(lat.Q)),
            ("e", -4.0 + 3.0 * c2),
            ("eps", 4.0 - 10.5 * c2 + 4.5 * c2 * c2),
            ("jx", cx),
            ("qx", (-5.0 + 3.0 * c2) * cx),
            ("jy", cy),
            ("qy", (-5.0 + 3.0 * c2) * cy),
            ("pxx", cx * cx - cy * cy),
            ("pxy", cx * cy),
        ]
    elif lat.D == 3:
        cz = c[:, 2]
        c2 = cx * cx + cy * cy + cz * cz
        rows = [
            ("rho", np.ones(lat.Q)),
            ("e", 19.0 * c2 - 30.0),
            ("eps", (21.0 * c2 * c2 - 53.0 * c2 + 24.0) / 2.0),
            ("jx", cx),
            ("qx", (5.0 * c2 - 9.0) * cx),
            ("jy", cy),
            ("qy", (5.0 * c2 - 9.0) * cy),
            ("jz", cz),
            ("qz", (5.0 * c2 - 9.0) * cz),
            ("pxx", 3.0 * cx * cx - c2),
            ("pixx", (3.0 * c2 - 5.0) * (3.0 * cx * cx - c2)),
            ("pww", cy * cy - cz * cz),
            ("piww", (3.0 * c2 - 5.0) * (cy * cy - cz * cz)),
            ("pxy", cx * cy),
            ("pyz", cy * cz),
            ("pxz", cx * cz),
            ("mx", (cy * cy - cz * cz) * cx),
            ("my", (cz * cz - cx * cx) * cy),
            ("mz", (cx * cx - cy * cy) * cz),
        ]
    else:
        raise ValueError(f"no MRT basis for D={lat.D}")
    names = tuple(n for n, _ in rows)
    M = np.stack([r for _, r in rows])
    gram = M @ M.T
    assert np.allclose(gram, np.diag(np.diag(gram))), \
        "MRT basis rows must be orthogonal"
    return M, names


# Ghost-moment (non-hydrodynamic) relaxation rates. Conserved moments get
# rate 0 (their deviations vanish identically); shear-stress moments get
# 1/tau (that is what sets the kinematic viscosity, same as BGK); the rest
# are free parameters tuned for stability. e/eps follow Lallemand & Luo
# (2000) [D2Q9] and d'Humieres et al. (2002) [D3Q19]. None → use 1/tau.
#
# D2Q9's energy-flux rates qx/qy default to 1/tau, NOT the literature 1.9:
# the reference-parity boundary chain (Zou-He columns applied over the full
# wall rows + the zeroed x-ghost columns, PARITY.md quirk #1) re-injects an
# O(0.04) non-equilibrium at the inlet/outlet corner cells on EVERY step,
# and any fixed q rate far from s_nu amplifies that loop until blow-up —
# measured on 512x128 tau=0.5768 f64: q=1.9 NaNs by t=420, the
# bounce-back "magic" q=8(2-s_nu)/(8-s_nu)=0.34 by t=700, while q=s_nu is
# stable for tau in [0.55, 0.8] and reproduces the BGK flow field. (The
# bulk periodic operator is stable for ANY of these rates — it is strictly
# a boundary-feedback effect; see tests/test_mrt.py's stability gate.)
# Below tau ≈ 0.55 the fixed e/eps literature rates join the same loop:
# at tau = 0.5384 (Re = 200 bench defaults) the defaults blow up by t = 400
# on 512×128 f32 even with clean corners. Overriding e → s_nu is measured
# stable at both 512×128 and the full 2048×512 (2240 steps); the
# eps-only override suffices at 512×128 but still blows up at 2048×512 —
# e is the dominant feedback rate at scale. Use --mrt-rates 'e=1.857' for
# near-tau-1/2 runs through the Zou-He inlet/outlet chain.
# D3Q19 keeps the literature values: its model BCs (equilibrium inlet +
# zero-gradient outlet) have no such re-injection loop — measured stable.
_MRT_GHOST_RATES = {
    2: {"e": 1.64, "eps": 1.54, "qx": None, "qy": None},
    3: {"e": 1.19, "eps": 1.4, "qx": 1.2, "qy": 1.2, "qz": 1.2,
        "pixx": 1.4, "piww": 1.4, "mx": 1.98, "my": 1.98, "mz": 1.98},
}
_MRT_SHEAR = {2: ("pxx", "pxy"),
              3: ("pxx", "pww", "pxy", "pyz", "pxz")}
_MRT_CONSERVED = ("rho", "jx", "jy", "jz")


def mrt_rates(lat: Lattice, inv_tau: float,
              overrides: dict[str, float] | None = None) -> np.ndarray:
    """(Q,) relaxation rate per moment row of _mrt_basis(lat)."""
    _, names = _mrt_basis(lat)
    ghost = dict(_MRT_GHOST_RATES[lat.D])
    if overrides:
        unknown = set(overrides) - set(names)
        if unknown:
            raise ValueError(f"unknown MRT moments {sorted(unknown)}; "
                             f"rows are {names}")
        ghost.update(overrides)
    out = []
    for n in names:
        if n in _MRT_CONSERVED:
            out.append(0.0)
        elif n in _MRT_SHEAR[lat.D]:
            out.append(inv_tau)
        else:
            v = ghost[n]
            out.append(inv_tau if v is None else float(v))
    return np.asarray(out, np.float64)


def mrt_relax_matrix(lat: Lattice, inv_tau: float,
                     overrides: dict[str, float] | None = None) -> np.ndarray:
    """R = M⁻¹ S M (Q, Q float64): the MRT update is
    f_post = f − R (f − feq), applied population-space — no moment-space
    intermediates at run time (Q² multiply-adds per cell). Entries below
    1e-13 are zeroed (S = s·I gives R ≈ s·I up
    to inversion rounding; pruning removes that noise and the structural
    zeros the velocity-set symmetry produces)."""
    M, _ = _mrt_basis(lat)
    S = np.diag(mrt_rates(lat, inv_tau, overrides))
    R = np.linalg.inv(M) @ S @ M
    R[np.abs(R) < 1e-13] = 0.0
    return R


def collide_mrt(lat: Lattice, f: jnp.ndarray, inv_tau: float,
                force: tuple[float, ...] = (),
                overrides: dict[str, float] | None = None) -> jnp.ndarray:
    """Multiple-relaxation-time collision (new capability — the reference
    is BGK-only, LBMSolver.h:101-123). Each moment relaxes at its own rate:
    shear stresses at 1/tau (so the viscosity is exactly BGK's
    nu = (tau − 1/2)/3 — gated by the MRT Poiseuille test), conserved
    moments not at all, ghost moments at tunable rates that damp the
    staircase/checkerboard modes BGK leaves marginally stable. With every
    rate set to 1/tau this IS BGK (R = (1/tau)·I), which the tests assert
    to 1e-12.

    Applied as f_post = f − R (f − feq) with the precomputed population-
    space matrix R (see mrt_relax_matrix); the per-plane loop skips R's
    structural zeros, exactly like the kernels' in-register version.
    """
    R = mrt_relax_matrix(lat, inv_tau, overrides)
    rho, u = moments(lat, f)
    feq = equilibrium(lat, rho, u)
    d = f - feq
    planes = []
    for i in range(lat.Q):
        acc = None
        for j in range(lat.Q):
            rij = float(R[i, j])
            if rij == 0.0:
                continue
            term = rij * d[j]
            acc = term if acc is None else acc + term
        planes.append(f[i] if acc is None else f[i] - acc)
    f_post = jnp.stack(planes).astype(f.dtype)
    if force:
        c = lat.c.astype(np.float64)
        F = np.asarray(force, dtype=np.float64)
        src = np.asarray(3.0 * lat.w * (c @ F))
        f_post = f_post + jnp.asarray(src, f.dtype).reshape(
            _wshape(lat, rho.ndim))
    return f_post


def smagorinsky_inv_tau(lat: Lattice, inv_rho: jnp.ndarray, devs,
                        inv_tau0: float, cs: float) -> jnp.ndarray:
    """Per-cell effective relaxation rate 1/tau_eff for the Smagorinsky
    subgrid closure (new capability — the reference has no turbulence
    model; its BGK at tau -> 1/2 simply blows up, README.md §4's unstable
    nominal-Re=200 point).

    The non-equilibrium momentum flux Pi_ab = Σ_i c_ia c_ib (f_i − feq_i)
    is, by Chapman-Enskog, −2 rho cs² tau S_ab, so the strain-rate norm
    |S| = sqrt(2 S:S) is Q̄/(2 rho cs² tau_eff) with Q̄ = sqrt(2 Σ_ab
    Pi_ab²). Setting nu_total = nu0 + (Cs Δ)² |S| (Δ = 1 lattice unit) and
    nu = cs² (tau − 1/2) gives a quadratic in tau_eff whose positive root
    is closed-form (Hou, Sterling, Chen & Doolen 1996):

        tau_eff = (tau0 + sqrt(tau0² + 18 Cs² Q̄ / rho)) / 2   (cs⁴ = 1/9)

    One sqrt + one divide per cell; tau_eff >= tau0 always, so
    the model only ever ADDS dissipation (that is the stabilizing
    property). devs: sequence of Q (f_i − feq_i) blocks.
    """
    c = lat.c
    ssum = None
    for a in range(lat.D):
        for b in range(a, lat.D):
            acc = None
            for i in range(lat.Q):
                coef = int(c[i, a]) * int(c[i, b])
                if coef == 0:
                    continue
                term = devs[i] if coef == 1 else (
                    -devs[i] if coef == -1 else coef * devs[i])
                acc = term if acc is None else acc + term
            w = 1.0 if a == b else 2.0  # off-diagonal pairs count twice
            term = w * (acc * acc)
            ssum = term if ssum is None else ssum + term
    qbar = jnp.sqrt(2.0 * ssum)
    tau0 = 1.0 / inv_tau0
    return 2.0 / (tau0 + jnp.sqrt(tau0 * tau0
                                  + (18.0 * cs * cs) * qbar * inv_rho))


# Truncated power-law bounds (Gabbanelli, Drazer & Koplik 2005): outside
# [GAMMA_FLOOR, ...] the apparent viscosity is clamped via tau in
# [PLAW_TAU_MIN, PLAW_TAU_MAX] — shear-thinning fluids (n < 1) diverge at
# zero shear, shear-thickening (n > 1) lose stability at tau -> 1/2.
PLAW_TAU_MIN = 0.5005
PLAW_TAU_MAX = 20.0
PLAW_ITERS = 8
PLAW_GAMMA_FLOOR = 1e-12


def power_law_inv_tau_from_gfac(gfac: jnp.ndarray, k: float,
                                n: float) -> jnp.ndarray:
    """Per-cell 1/tau_eff from gfac = γ̇·tau = 3 Q̄ / (2 rho) (cs² = 1/3).

    Solves the implicit truncated power-law root
        (tau − 1/2) · tau^(n−1) = 3k · gfac^(n−1)
    by PLAW_ITERS Newton iterations on λ = log(tau − 1/2):
        R(λ) = λ + (n−1)·log tau − log(3k) − (n−1)·log gfac,
        R'(λ) = 1 + (n−1)(tau − 1/2)/tau  ∈  [min(n,1), max(n,1)].
    The λ-space slope is bounded away from 0 and ∞ for every n > 0 and
    EVERY tau (a Newton step on tau itself is not: its h' = 1 + (n−1)p/tau
    turns negative for shear-thinning fluids at low shear, where
    p = 3k γ̇^(n−1) blows up, and drives cells to the minimum-viscosity
    clamp instead of the maximum — the exact opposite of the Gabbanelli
    truncation), so the iteration is globally well-conditioned; iterates
    are clamped to λ ∈ [log(TAU_MIN − 1/2), log(TAU_MAX − 1/2)].

    """
    nm1 = float(n) - 1.0
    lam_lo = float(np.log(PLAW_TAU_MIN - 0.5))
    lam_hi = float(np.log(PLAW_TAU_MAX - 0.5))
    # constant part of the residual; k > 0 always (config derives k from
    # tau when unset, and tau > 1/2)
    gl = jnp.log(jnp.maximum(gfac, PLAW_GAMMA_FLOOR))
    const = float(np.log(3.0 * k))
    lam = jnp.zeros_like(gfac)
    for _ in range(PLAW_ITERS):
        tau = 0.5 + jnp.exp(lam)
        r = lam + nm1 * jnp.log(tau) - const - nm1 * gl
        rp = 1.0 + nm1 * (tau - 0.5) / tau
        lam = jnp.clip(lam - r / rp, lam_lo, lam_hi)
    return 1.0 / (0.5 + jnp.exp(lam))


def power_law_inv_tau(lat: Lattice, inv_rho: jnp.ndarray, devs,
                      k: float, n: float) -> jnp.ndarray:
    """Per-cell effective relaxation rate 1/tau_eff for an Ostwald-de
    Waele (power-law) fluid: nu(γ̇) = k γ̇^(n-1) (new capability — the
    reference is strictly Newtonian).

    By Chapman-Enskog the shear rate is γ̇ = |S| = Q̄ / (2 rho cs² tau_eff)
    with Q̄ = sqrt(2 Σ_ab Pi_ab²), Pi_ab = Σ_i c_ia c_ib (f_i − feq_i) —
    the same non-equilibrium stress norm the Smagorinsky closure uses. But
    where LES gives a closed-form root, nu = k γ̇^(n-1) makes
    tau = 1/2 + 3 k γ̇(tau)^(n-1) implicit; power_law_inv_tau_from_gfac
    solves it (see there for the solver and its clamps).

    devs: sequence of Q (f_i − feq_i) blocks. n = 1 reduces to constant
    tau = 1/2 + 3k (Newtonian)."""
    c = lat.c
    ssum = None
    for a in range(lat.D):
        for b in range(a, lat.D):
            acc = None
            for i in range(lat.Q):
                coef = int(c[i, a]) * int(c[i, b])
                if coef == 0:
                    continue
                term = devs[i] if coef == 1 else (
                    -devs[i] if coef == -1 else coef * devs[i])
                acc = term if acc is None else acc + term
            w = 1.0 if a == b else 2.0
            term = w * (acc * acc)
            ssum = term if ssum is None else ssum + term
    qbar = jnp.sqrt(2.0 * ssum)
    # γ̇ · tau = 3 Q̄ / (2 rho)  (cs² = 1/3)
    gfac = 1.5 * qbar * inv_rho
    return power_law_inv_tau_from_gfac(gfac, k, n)


def collide_power_law(lat: Lattice, f: jnp.ndarray, k: float, n: float,
                      force: tuple[float, ...] = ()) -> jnp.ndarray:
    """BGK collision with the per-cell power-law relaxation rate of
    power_law_inv_tau."""
    rho, u = moments(lat, f)
    feq = equilibrium(lat, rho, u)
    devs = f - feq
    inv_t = power_law_inv_tau(lat, 1.0 / rho, devs, k, n)
    f_post = f - inv_t[None] * devs
    if force:
        c = lat.c.astype(np.float64)
        F = np.asarray(force, dtype=np.float64)
        src = np.asarray(3.0 * lat.w * (c @ F))
        f_post = f_post + jnp.asarray(src, f.dtype).reshape(
            _wshape(lat, rho.ndim))
    return f_post


def collide_smagorinsky(lat: Lattice, f: jnp.ndarray, inv_tau: float,
                        cs: float,
                        force: tuple[float, ...] = ()) -> jnp.ndarray:
    """BGK collision with the Smagorinsky eddy-viscosity closure: the
    relaxation rate becomes the per-cell 1/tau_eff of smagorinsky_inv_tau.
    With Cs = 0 (or zero shear) this is exactly `collide`."""
    rho, u = moments(lat, f)
    feq = equilibrium(lat, rho, u)
    devs = f - feq
    inv_t = smagorinsky_inv_tau(lat, 1.0 / rho, devs, inv_tau, cs)
    f_post = f - inv_t[None] * devs
    if force:
        c = lat.c.astype(np.float64)
        F = np.asarray(force, dtype=np.float64)
        src = np.asarray(3.0 * lat.w * (c @ F))
        f_post = f_post + jnp.asarray(src, f.dtype).reshape(
            _wshape(lat, rho.ndim))
    return f_post


def shan_chen_psi(rho: jnp.ndarray, rho0: float = 1.0) -> jnp.ndarray:
    """Shan-Chen pseudopotential ψ(ρ) = ρ0 (1 − e^(−ρ/ρ0)) (Shan & Chen
    1993, the standard exponential form — bounded, so the interaction
    saturates in the liquid phase). New capability: the reference is
    strictly single-phase."""
    return rho0 * (1.0 - jnp.exp(-rho / rho0))


def shan_chen_pressure(rho: jnp.ndarray, g: float,
                       rho0: float = 1.0) -> jnp.ndarray:
    """Bulk equation of state P = ρ cs² + (g cs²/2) ψ(ρ)² of the
    pseudopotential fluid (cs² = 1/3) — what the Laplace-law gate
    evaluates inside/outside a droplet."""
    psi = shan_chen_psi(rho, rho0)
    return rho / 3.0 + (g / 6.0) * psi * psi


def collide_shan_chen(lat: Lattice, f: jnp.ndarray, inv_tau: float,
                      F) -> jnp.ndarray:
    """BGK collision with the Shan-Chen velocity-shift forcing: relax
    toward equilibrium(ρ, u + τ F / ρ) (Shan & Chen 1993). The physical
    (half-step-corrected) velocity for output is u + F/(2ρ); the shift
    here is what generates the non-ideal pressure tensor. F: (D, *spatial)
    force field (assembled by the step from ψ-neighbor sums)."""
    rho, u = moments(lat, f)
    u_eq = u + (1.0 / inv_tau) * F / rho
    feq = equilibrium(lat, rho, u_eq)
    return f - inv_tau * (f - feq)


def thermal_equilibrium(lat_g: Lattice, T: jnp.ndarray,
                        u: jnp.ndarray) -> jnp.ndarray:
    """Advection-diffusion equilibrium for a passive scalar carried by the
    flow: g_eq_i = w_i T (1 + 3 c_i·u) (linear in u — the scalar has no
    momentum flux of its own). Recovers dT/dt + u·∇T = alpha ∇²T with
    alpha = (tau_g − 1/2)/3 (gated by the decay test in tests/test_thermal.py).
    New capability — the reference is isothermal."""
    c = lat_g.c
    planes = []
    for i in range(lat_g.Q):
        cu = None
        for d in range(lat_g.D):
            cid = int(c[i, d])
            if cid == 0:
                continue
            term = u[d] if cid > 0 else -u[d]
            cu = term if cu is None else cu + term
        if cu is None:
            planes.append(lat_g.w[i] * T)
        else:
            planes.append(lat_g.w[i] * T * (1.0 + 3.0 * cu))
    return jnp.stack(planes).astype(T.dtype)


def rest_equilibrium(lat: Lattice, dtype=np.float64) -> np.ndarray:
    """Equilibrium at (rho=1, u=0) — just the weights. This is what the
    reference's solid cells hold forever in f_next (see note below)."""
    return lat.w.astype(dtype)


def uniform_equilibrium(lat: Lattice, rho: float, u: tuple[float, ...],
                        dtype=np.float64) -> np.ndarray:
    """Per-direction equilibrium values for a spatially uniform (rho, u) as a
    host-side (Q,) constant. Used for initialization (LBMGrid.h:185-246) and
    for the frozen ghost-ring values at global boundaries: the reference
    initializes ghost cells to equilibrium(1, U_in) and never updates them at
    physical domain edges (LBMGrid.h:188-213), so streaming at domain edges
    forever pulls these constants; we reproduce that exactly."""
    c = lat.c.astype(np.float64)
    uv = np.asarray(u, dtype=np.float64)
    cu = c @ uv
    usq = float(uv @ uv)
    feq = lat.w * rho * (1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * usq)
    return feq.astype(dtype)


def is_stable(f: jnp.ndarray, bound: float = 1e5) -> jnp.ndarray:
    """Global stability predicate: all populations finite and |f| < bound.

    Parity: LBMUtils.h:129-131 + LBMGrid.h:285-317. The reference runs this
    every timestep with an MPI_Allreduce; we evaluate it once per scan chunk
    (NaN/Inf persist under LBM arithmetic, so a chunk-end check gives the same
    abort guarantee at 1/output_frequency of the sync cost — SURVEY §7).
    """
    return jnp.all(jnp.isfinite(f) & (jnp.abs(f) < bound))


def max_velocity(lat: Lattice, f: jnp.ndarray,
                 solid: jnp.ndarray | None = None) -> jnp.ndarray:
    """max |u| over the domain (solids report u=0). Parity: LBMGrid.h:319-344."""
    rho, u = moments(lat, f)
    vel2 = jnp.sum(u * u, axis=0)
    if solid is not None:
        vel2 = jnp.where(solid, 0.0, vel2)
    return jnp.sqrt(jnp.max(vel2))
