"""Sub-cycled ionization/heating driver (reference:
src/ionradiation/ionrad_3d.c:862-1047, ion_radtransfer_3d).

Runs BEFORE the hydro update each cycle and may SHRINK the hydro dt
(pGrid->dt = dt_done → pMesh->dt, ionrad_3d.c:983,1000,1033) — hence the
step function treats dt as a value produced here, and the sub-cycle is a
lax.while_loop with data-dependent trip count.  All reductions (dt_chem,
dt_therm minima, check_range cell count, compute_dt_hydro) are jnp
reductions; under pjit they lower to the same global collectives the
reference does with MPI_Allreduce (ionrad_3d.c:397-404, 552-559, 274-280).

Everything operates on ACTIVE cells only (the reference's is..ie loops);
ghosts are refreshed by bvals after radiation, as in main.c:552.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1, TINY_NUMBER
from ..state import State
from . import chemistry as chem
from .config import (CION, DAMPFACTOR, IONFRACFLOOR, LARGE, MAXCELLCOUNT,
                     MAXSIGNCOUNT, IonConfig)
from .plane import get_ph_rate_plane, inlet_ramp


class _Carry(NamedTuple):
    E: jax.Array
    s0: jax.Array
    last_sign: jax.Array
    sign_count: jax.Array
    dt_done: jax.Array
    dt_new: jax.Array
    niter: jax.Array
    stop: jax.Array
    eflux: jax.Array


def _temp(E, s0, d, ke_be, sim, ion, di=None):
    """T, e_th, x — with one shared reciprocal di = 1/d feeding both the
    ionization fraction (x = n_e/(n_H+n_Hplus) with n_H+n_Hplus = d/m_H)
    and the specific energy (one divide fewer per cell; equal to the naive
    form to roundoff)."""
    if di is None:
        di = 1.0 / d
    n_Hplus = (d - s0) * (1.0 / ion.m_H)
    n_e = n_Hplus + d * (ion.alpha_C / (14.0 * ion.m_H))
    x = n_e * (ion.m_H * di)
    e_th = E - ke_be
    e_sp = e_th * di
    T = chem.temperature(e_sp, x, sim.gamma_1, ion)
    return T, e_th, x


def _apply_floors(E, s0, d, ke_be, sim: SimConfig, ion: IonConfig,
                  di=None):
    """apply_temp_floor (ionrad_3d.c:70-136) then apply_neutral_floor
    (:140-157), in the driver's order (:896-900)."""
    T, _, x = _temp(E, s0, d, ke_be, sim, ion, di=di)
    mm = chem.mean_mass(x, ion)
    inv_mmg1 = 1.0 / (mm * sim.gamma_1)
    E = jnp.where(T < ion.tfloor,
                  ke_be + (ion.tfloor * ion.k_B) * inv_mmg1 * d, E)
    if ion.tceil > 0:
        E = jnp.where(T > ion.tceil,
                      ke_be + (ion.tceil * ion.k_B) * inv_mmg1 * d, E)

    d_nlim = jnp.minimum(d * IONFRACFLOOR, ion.d_nlo)
    s0 = jnp.where(s0 < d_nlim, d_nlim, jnp.minimum(s0, d))
    return E, s0


def _d_nlim(d, ion):
    return jnp.minimum(d * IONFRACFLOOR, ion.d_nlo)


# ---------------------------------------------------------------------------
# Pure per-cell physics (no reductions); the sub-cycle below adds the global
# dt minima and the stop-criterion reductions.
# ---------------------------------------------------------------------------


def rates_percell(s0, E, d, ke_be, last_sign, sign_count, ph_rate, d_nlim,
                  sim: SimConfig, ion: IonConfig):
    """compute_chem_rates + compute_therm_rates per cell
    (ionrad_3d.c:288-409, 414-562).  Note: the reference also damps the
    *stale* edot in chem_rates, which therm_rates then overwrites
    unconditionally — only the nHdot damping survives; we implement exactly
    that surviving behavior.

    Returns (nHdot, new_sign, new_count, dt_chem_cell, edot, dt_therm_cell).
    """
    di = 1.0 / d
    n_H = s0 * (1.0 / ion.m_H)
    n_Hplus = (d - s0) * (1.0 / ion.m_H)
    n_e = n_Hplus + d * (ion.alpha_C / (14.0 * ion.m_H))
    x = n_e * (ion.m_H * di)       # n_H + n_Hplus = d/m_H
    e_sp = (E - ke_be) * di
    T = chem.temperature(e_sp, x, sim.gamma_1, ion)
    # shared-log power laws: alpha_B(Tc) and the recombination-cooling
    # coefficient are both pure powers of T, so one log(T) feeds both
    # exp()s (two transcendentals fewer per cell; equal to the naive
    # pow() to roundoff).  Tc = max(T, tfloor) gives
    # log(Tc) = max(log T, log tfloor) by monotonicity.
    import math
    lnT = jnp.log(T)
    lnTc = jnp.maximum(lnT, math.log(ion.tfloor))
    alpha_B = 2.59e-13 * jnp.exp(-0.7 * (lnTc - math.log(1.0e4)))
    nHdot = (alpha_B * ion.time_unit * n_e * n_Hplus
             - ph_rate * n_H)

    # oscillation bookkeeping (:341-353); neg/pos are exclusive so the
    # nested where collapses to a boolean expression
    neg = nHdot < 0.0
    pos = nHdot > 0.0
    flipped = (neg & (last_sign == 1)) | (pos & (last_sign == -1))
    new_count = jnp.where(
        neg | pos,
        jnp.where(flipped, sign_count + 1,
                  jnp.maximum(sign_count - (sign_count > 0), 0)),
        0)
    new_sign = jnp.where(neg, -1, jnp.where(pos, 1, 0)).astype(
        last_sign.dtype)
    # damping: nHdot *= DAMPFACTOR^(sign_count - MAXSIGNCOUNT) (:360-363).
    # DAMPFACTOR = 0.5, so the power is an exact 2^-n — evaluate by
    # 8-bit square-and-multiply (6 selects+muls, no transcendental; every
    # partial product is an exact power of two, so this equals pow()).
    ndamp = jnp.minimum(jnp.maximum(new_count - MAXSIGNCOUNT, 0), 255)
    damp = jnp.ones_like(nHdot)
    for k in range(8):
        damp = damp * jnp.where((ndamp >> k) & 1 == 1,
                                nHdot.dtype.type(DAMPFACTOR ** (2 ** k)),
                                nHdot.dtype.type(1.0))
    nHdot = nHdot * damp

    mx = ion.max_dx_iter
    inv_nHdot = 1.0 / nHdot          # one divide feeds all four limits
    dt1_pos = mx / (1 + mx) * n_e * inv_nHdot
    dt2_pos = mx * n_H * inv_nHdot
    dt1_neg = -mx * n_e * inv_nHdot
    dt2_neg = -mx / (1 + mx) * n_H * inv_nHdot
    above_floor = s0 > 1.0001 * d_nlim
    big = jnp.finfo(s0.dtype).max  # LARGE ~ DBL_MAX (ionrad.h:16)
    dt_chem_cell = jnp.where(
        nHdot > 0.0, jnp.minimum(dt1_pos, dt2_pos),
        jnp.where((nHdot < 0.0) & above_floor,
                  jnp.minimum(dt1_neg, dt2_neg), big))

    # --- therm (compute_therm_rates, :414-562) ---
    e_thermal = E - ke_be
    # recomb_cool_rate_coef·k_B·T = 6.11e-10·k_B·T^0.11 (power law →
    # shared lnT); lya = -7.5e-19·n_e·n_H·exp(-118348/T)
    crec = jnp.where(T < 100.0, 0.0,
                     (6.11e-10 * ion.k_B)
                     * jnp.exp(0.11 * lnT))
    lya = -7.5e-19 * n_e * n_H * jnp.exp(-118348.0 / T)
    edot = (ph_rate * ion.e_gamma * n_H
            - crec * ion.time_unit * n_Hplus * n_e
            + lya * ion.time_unit)
    skip = (T < ion.tfloor) | ((nHdot < 0) & (s0 < 1.0001 * d_nlim))
    edot = jnp.where(skip, 0.0, edot)

    mde, mdt = ion.max_de_iter, ion.max_de_therm_iter
    inv_edot = 1.0 / edot            # one divide feeds all four limits
    dt_heat = jnp.minimum(mde * E * inv_edot, mdt * e_thermal * inv_edot)
    # cooling: account for the temperature floor (:503-538)
    mm = chem.mean_mass(x, ion)
    e_th_min = (ion.tfloor * ion.k_B / sim.gamma_1) * d / mm
    e_min = ke_be + e_th_min
    floor_ok = (e_thermal < (1.0 + mdt) * e_th_min) & \
               (E < (1.0 + mde) * e_min)
    dt_cool = jnp.minimum(-mde / (1 + mde) * E * inv_edot,
                          -mdt / (1 + mdt) * e_thermal * inv_edot)
    dt_therm_cell = jnp.where(
        edot == 0.0, big,
        jnp.where(edot > 0.0, dt_heat,
                  jnp.where(floor_ok, big, dt_cool)))
    return nHdot, new_sign, new_count, dt_chem_cell, edot, dt_therm_cell


def update_percell(s0, E, d, ke_be, nHdot, edot, ph_rate, dt, d_nlim,
                   e_init, e_th_init, x_init, sim: SimConfig,
                   ion: IonConfig, di=None):
    """ionization_update (:565-590) + floors + check_range violation flags
    (:977-1002, :222-224).  Returns (E_new, s0_new, viol_cell) with
    viol_cell ∈ {0,1} as the state dtype (exact for any realistic count)."""
    if di is None:
        di = 1.0 / d
    upd = (nHdot > 0) | (s0 > 1.0001 * d_nlim)
    E2 = E + jnp.where(upd, edot * dt, 0.0)
    s02 = s0 + jnp.where(upd, nHdot * dt * ion.m_H, 0.0)
    E2, s02 = _apply_floors(E2, s02, d, ke_be, sim, ion, di=di)

    _, e_th, x = _temp(E2, s02, d, ke_be, sim, ion, di=di)
    n_H = s02 * (1.0 / ion.m_H)
    # ratio tests as multiply-compares (all quantities positive): one
    # divide fewer per test pair; r >= c  <=>  num >= c*den for den > 0
    dtype_skip = ph_rate > (2.0 * CION) * (ion.min_area * n_H)
    viol = jnp.zeros_like(dtype_skip)
    if ion.max_de_therm_step > 0:
        c = 1 + ion.max_de_therm_step
        viol = viol | (e_th >= c * e_th_init) | (e_th_init >= c * e_th)
    if ion.max_de_step > 0:
        c = 1 + ion.max_de_step
        viol = viol | (E2 >= c * e_init) | (e_init >= c * E2)
    if ion.max_dx_step > 0:
        c = 1 + ion.max_dx_step
        viol = viol | (x >= c * x_init) | (x_init >= c * x)
    viol_cell = (viol & ~dtype_skip).astype(E.dtype)
    return E2, s02, viol_cell


def dti_percell(s0_unused, E, d, M1, M2, M3, sim: SimConfig,
                grid: GridConfig, B=None, Bfi=None):
    """Per-cell max over active axes of (|v_a| + c_f,a)/dx_a
    (compute_dt_hydro, ionrad_3d.c:593-678).  The global CFL dt is
    cour_no / max(dti)."""
    di = 1.0 / d
    qsq = (M1 ** 2 + M2 ** 2 + M3 ** 2) * di * di
    if sim.mhd:
        b1 = B[0] + jnp.abs(Bfi[0] - B[0])
        b2 = B[1] + jnp.abs(Bfi[1] - B[1])
        b3 = B[2] + jnp.abs(Bfi[2] - B[2])
        bsq = b1 * b1 + b2 * b2 + b3 * b3
        if sim.adiabatic:
            p = jnp.maximum(
                sim.gamma_1 * (E - 0.5 * d * qsq - 0.5 * bsq),
                TINY_NUMBER)
            asq = sim.gamma * p * di
        else:
            asq = sim.iso_csound ** 2
        tsum = bsq * di + asq
        tdif = bsq * di - asq
        cfsq = [
            0.5 * (tsum + jnp.sqrt(tdif * tdif
                                   + 4.0 * asq * (b2 * b2 + b3 * b3) * di)),
            0.5 * (tsum + jnp.sqrt(tdif * tdif
                                   + 4.0 * asq * (b1 * b1 + b3 * b3) * di)),
            0.5 * (tsum + jnp.sqrt(tdif * tdif
                                   + 4.0 * asq * (b1 * b1 + b2 * b2) * di)),
        ]
    else:
        if sim.adiabatic:
            p = jnp.maximum(sim.gamma_1 * (E - 0.5 * d * qsq),
                            TINY_NUMBER)
            asq = sim.gamma * p * di
        else:
            asq = jnp.full_like(E, sim.iso_csound ** 2)
        cfsq = [asq, asq, asq]
    M = [M1, M2, M3]
    dti = jnp.zeros_like(E)
    for a in range(3):
        if grid.Nx[a] > 1:
            v = jnp.abs(M[a]) * di
            dti = jnp.maximum(dti, (v + jnp.sqrt(cfsq[a])) / grid.dx[a])
    return dti


def ion_radtransfer(state: State, sim: SimConfig, grid: GridConfig,
                    ion: IonConfig, time, cour_no: float,
                    inlet=None, tcoarse=None, return_niter=False,
                    mesh=None):
    """One radiation step: floors + sub-cycled chemistry/heating.

    `cour_no` is <time>/cour_no, needed by the compute_dt_hydro stopping
    criterion.  Returns (new_state, dt_new): state with updated E, s0,
    Eflux and the (possibly shrunk) hydro dt for this cycle.

    SMR fine-level mode (ionrad_3d.c:914-962, 1004-1013): with `tcoarse`
    set, the sub-cycle integrates exactly to tcoarse — the root level's
    dt_done — without any dt feedback, and `inlet` (a per-column array
    from the parent's EdgeFlux, smr.child_inlet_flux) replaces the
    time-ramped domain-face inflow.
    """
    sl = grid.interior()
    Usl = (slice(None),) + sl
    U = state.U[Usl]
    d = U[ID]
    M1, M2, M3 = U[IM1], U[IM1 + 1], U[IM1 + 2]
    ke = 0.5 * (M1 ** 2 + M2 ** 2 + M3 ** 2) / d
    if sim.mhd:
        B = state.Bcc[(slice(None),) + sl]
        ke_be = ke + 0.5 * (B[0] ** 2 + B[1] ** 2 + B[2] ** 2)
    else:
        ke_be = ke
    iscal = 5 if sim.adiabatic else 4
    E0 = U[IEN]
    s00 = U[iscal]
    dt0 = state.dt

    # floors + saved initial values (ionrad_3d.c:896-905)
    E0, s00 = _apply_floors(E0, s00, d, ke_be, sim, ion)
    _, e_th_init, x_init = _temp(E0, s00, d, ke_be, sim, ion)
    e_init = E0
    d_nlim = _d_nlim(d, ion)

    direction, flux_i = (ion.radplanes[0] if ion.radplanes
                         else (-1, 0.0))
    n_planes = len(ion.radplanes)

    # distributed sweep: with the sweep (x) axis sharded over the device
    # mesh, the attenuation scan runs blockwise with a ppermute-carried
    # prefix (plane.get_ph_rate_plane_dist); the Eflux carry then splits
    # into (left faces [sharded], per-shard exit faces) so the hot loop
    # never reshards an (Nx+1)-face array
    dist = (mesh is not None and mesh.shape.get("x", 1) > 1
            and n_planes == 1 and direction == -1 and inlet is None)
    # coverage guard: a plane whose SWEEP axis is sharded must use the
    # distributed scan — the serial cumprod would otherwise be taken
    # shard-local by shard_map-style consumers.  Planes sweeping an
    # UNSHARDED axis stay on the serial path, which GSPMD partitions
    # correctly (the scan axis is device-local).  Unsupported sharded
    # combinations (SMR inlet mode, multi-plane, +1/±2/±3 sweeps along
    # a sharded axis) fail loudly instead of silently degrading
    # (reference pipeline: ionradplane_3d.c:226-318).
    if mesh is not None and not dist:
        _axname = {1: "x", 2: "y", 3: "z"}
        for _dirn, _ in ion.radplanes:
            if mesh.shape.get(_axname[abs(_dirn)], 1) > 1:
                raise NotImplementedError(
                    f"radiation plane dir={_dirn}: sweep axis "
                    f"'{_axname[abs(_dirn)]}' is sharded "
                    f"{dict(mesh.shape)} but the distributed scan only "
                    "covers a single dir=-1 plane without SMR inlet "
                    "flux; reshard the mesh or run this plane "
                    "unsharded along its sweep axis")

    def ph_rate_all(s0):
        """Photoionization rate summed over all planes (ionrad_3d.c:926-931);
        EdgeFlux keeps the last plane's values, like the reference."""
        kph_tot = jnp.zeros_like(s0)
        eflux = None
        for dirn, fx in ion.radplanes:
            if inlet is not None:
                inflow = jnp.asarray(inlet, s0.dtype)
            elif abs(dirn) == 1:
                inflow = inlet_ramp(fx, time, ion)
            else:
                inflow = jnp.asarray(fx, s0.dtype)
            if dist:
                from .plane import get_ph_rate_plane_dist
                kph, el, ex = get_ph_rate_plane_dist(s0, inflow, dirn,
                                                     grid, ion, mesh)
                eflux = (el, ex)
            else:
                kph, eflux = get_ph_rate_plane(s0, inflow, dirn, grid, ion)
            kph_tot = kph_tot + kph
        # point sources (ionradpoint_3d.c analogue): dense HEALPix ray
        # fan, gather/scan/scatter — see ionrad/point.py
        for src_pos, ndot in ion.point_sources:
            from .point import point_source_kph
            kph_tot = kph_tot + point_source_kph(s0, src_pos, ndot,
                                                 grid, ion)
        if eflux is None:
            ax0 = abs(direction) - 1
            shp = list(s0.shape)
            shp[2 - ax0] += 1
            eflux = jnp.zeros(shp, s0.dtype)
        return kph_tot, eflux

    if sim.mhd:
        Bsl = B
        Bfi = [state.B1i[sl], state.B2i[sl], state.B3i[sl]]
    else:
        Bsl = Bfi = None

    def _finish(out, ef_pair):
        """dt feedback, state assembly, eflux reassembly."""
        # maxiter exit without a stop condition: dt = dt_done
        # (ionrad_3d.c:1022)
        if tcoarse is None:
            dt_new = jnp.where(out.stop, out.dt_new, out.dt_done)
        else:
            dt_new = dt0   # fine levels never feed back into the mesh dt
        Unew = state.U.at[(iscal,) + sl].set(out.s0)
        if sim.adiabatic:
            Unew = Unew.at[(IEN,) + sl].set(out.E)
        if ef_pair is not None:
            # reassemble the legacy (Nx+1)-face array once, post-loop
            eflux_out = jnp.concatenate([ef_pair[0],
                                         ef_pair[1][..., -1:]], axis=-1)
        else:
            eflux_out = out.eflux
        new_state = state.replace(U=Unew, Eflux=eflux_out, dt=dt_new)
        if return_niter:
            return new_state, dt_new, out.niter
        return new_state, dt_new

    def body(c: _Carry):
        kph, eflux = ph_rate_all(c.s0)
        nHdot, lsn, scn, dtc_cell, edot, dtt_cell = rates_percell(
            c.s0, c.E, d, ke_be, c.last_sign, c.sign_count, kph,
            d_nlim, sim, ion)
        dt_chem = jnp.min(dtc_cell)
        dt_therm = jnp.min(dtt_cell)
        dt = jnp.minimum(dt_chem, dt_therm)

        # clip to the hydro step, or to the root level's tcoarse in SMR
        # fine-level mode (ionrad_3d.c:950-962)
        dt_limit = dt0 if tcoarse is None else tcoarse
        hydro_done = c.dt_done + dt > dt_limit
        dt = jnp.where(hydro_done, dt_limit - c.dt_done, dt)

        # explicit update + floors + stopping criteria (:565-590, :977-1002)
        E, s0, viol_cell = update_percell(
            c.s0, c.E, d, ke_be, nHdot, edot, kph, dt, d_nlim,
            e_init, e_th_init, x_init, sim, ion)
        cellcount = jnp.sum(viol_cell)
        dti_max = jnp.max(dti_percell(None, E, d, M1, M2, M3, sim,
                                      grid, Bsl, Bfi))
        dt_done = c.dt_done + dt
        range_hit = cellcount > MAXCELLCOUNT

        dt_h = cour_no / dti_max
        cfl_hit = dt_h < dt_done

        if tcoarse is None:
            stop = range_hit | hydro_done | cfl_hit
            dt_new = jnp.where(range_hit, dt_done,
                               jnp.where(hydro_done, c.dt_new,
                                         jnp.where(cfl_hit, dt_done,
                                                   c.dt_new)))
        else:
            # fine level: integrate to tcoarse regardless; no dt feedback
            stop = hydro_done
            dt_new = c.dt_new
        return _Carry(E, s0, lsn, scn, dt_done, dt_new, c.niter + 1, stop,
                      eflux)

    def cond(c: _Carry):
        return (~c.stop) & (c.niter < ion.maxiter)

    ax = abs(direction) - 1
    efshape = list(d.shape)
    efshape[2 - ax] += 1
    if dist:
        eflux0 = (jnp.zeros(d.shape, d.dtype),
                  jnp.zeros(d.shape[:2] + (mesh.shape["x"],), d.dtype))
    else:
        eflux0 = jnp.zeros(efshape, d.dtype)
    init = _Carry(
        E=E0, s0=s00,
        last_sign=jnp.zeros(d.shape, jnp.int32),
        sign_count=jnp.zeros(d.shape, jnp.int32),
        dt_done=jnp.zeros((), d.dtype),
        dt_new=dt0,
        niter=jnp.zeros((), jnp.int32),
        stop=jnp.zeros((), bool),
        eflux=eflux0)

    out = jax.lax.while_loop(cond, body, init)
    return _finish(out, out.eflux if dist else None)
