"""Driver: setup + main loop (reference: src/main.c:90-772).

The reference's 10-step startup and its main loop
(output → diffusion → radiation → hydro → Userwork → time/dt update → BCs,
src/main.c:519-669) map to:

  - ``Simulation.from_file`` / ``from_par``: par parsing, config build,
    problem init, initial ghost fill, initial dt (main.c steps 1-9).
  - ``Simulation.step()``: ONE fully jitted mesh update.  dt is a traced
    value *produced inside the step* because the radiation sub-cycle may
    shrink it (ionrad_3d.c:983,1033 → pMesh->dt), matching the reference's
    radiation-before-hydro ordering contract (main.c:541-585).
  - ``Simulation.run()``: host-side loop with output scheduling, tlim/nlim
    termination, and zone-cycles/sec reporting (main.c:699-735).
"""

from __future__ import annotations

import re
import time as _time
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import bvals, dt as dt_mod
from .config import (GridConfig, SimConfig, grid_config_from_par,
                     sim_config_from_par)
from .models import get_problem
from .par import ParameterDB
from .state import State


def parse_configure_line(par: ParameterDB) -> dict:
    """Extract --with-*/--enable-* options from the deck's embedded configure
    line (the reference records it in the <comment> block; e.g.
    tst/1D-hydro/athinput.sod 'config = --with-gas=hydro ...')."""
    out = {}
    cfgline = par.gets_def("comment", "config", "")
    for m in re.finditer(r"--with-(\w[\w-]*)=(\S+)", cfgline):
        key, val = m.group(1), m.group(2)
        if key == "gas":
            out["gas"] = val
        elif key == "eos":
            out["eos"] = val
        elif key == "flux":
            out["flux"] = val
        elif key == "order":
            out["order"] = val
        elif key == "integrator":
            out["integrator"] = val
        elif key == "nscalars":
            out["nscalars"] = int(val)
        elif key == "problem":
            out["_problem"] = val
        elif key == "coord":
            out["_coord"] = val
        elif key == "gravity":
            # --with-gravity=fft|fft_obc|multigrid (configure.ac)
            out["self_gravity"] = True
            out["selfg_solver"] = val
    for m in re.finditer(r"--enable-(\w[\w-]*)", cfgline):
        key = m.group(1)
        if key == "h-correction":
            out["h_correction"] = True
        elif key == "special-relativity":
            out["special_relativity"] = True
        elif key == "ion-radiation":
            out["ion_radiation"] = True
        elif key == "ion-plane":
            out["ion_radplane"] = True
        elif key == "shearing-box":
            out["shearing_box"] = True
        elif key == "fargo":
            out["fargo"] = True
    if out.get("ion_radplane") and out.get("nscalars", 0) < 1:
        out["nscalars"] = 1
    return out


class Simulation:
    def __init__(self, par: ParameterDB, sim: SimConfig, grid: GridConfig,
                 problem, state: State):
        self.par = par
        self.sim = sim
        self.grid = grid
        self.problem = problem
        self.state = state
        self.cour_no = par.getd_def("time", "cour_no", 0.8)
        self.tlim = par.getd_def("time", "tlim", 1.0)
        self.nlim = par.geti_def("time", "nlim", -1)
        self._jit_step = None
        # optional jax.sharding.Mesh for multichip runs: enables the
        # distributed (x-sharded) radiation scan inside the step
        self.mesh = None
        # optional Lagrangian particle population (see from_par)
        self.particles = None
        self.par_params = None

    # ------------------------------------------------------------------ setup

    @classmethod
    def from_par(cls, par: ParameterDB, problem: Optional[str] = None,
                 **sim_overrides) -> "Simulation":
        # multi-<domainN> decks use the SMR hierarchy driver; <job>
        # num_domains caps how many blocks are honored (init_mesh.c)
        if (par.geti_def("job", "num_domains", 1) > 1
                and par.exist("domain2", "level")):
            from .hierarchy import MeshSimulation
            return MeshSimulation.from_par(par, problem=problem,
                                           **sim_overrides)
        auto = parse_configure_line(par)
        problem = problem or auto.pop("_problem", None)
        auto.pop("_problem", None)
        coord = auto.pop("_coord", "cartesian")
        if problem is None:
            raise ValueError("no problem name given or found in deck")
        auto.update(sim_overrides)
        coord = auto.pop("coord", coord)
        prob_cls = get_problem(problem)
        for k, v in getattr(prob_cls, "sim_overrides", {}).items():
            auto.setdefault(k, v)
        coord = getattr(prob_cls, "coord", coord)
        sim = sim_config_from_par(par, **auto)
        grid = grid_config_from_par(par, coord=coord)
        prob = prob_cls(par, sim, grid)
        state = prob.init(par, sim, grid)
        state = bvals.apply_bc(state, grid, sim, prob)
        dt0 = dt_mod.new_dt(state, sim, grid, cls._cour(par))
        state = state.replace(dt=dt0)
        out = cls(par, sim, grid, prob, state)
        # Lagrangian particles: a problem providing init_particles() opts
        # in (init_particle.c analogue); advanced after each gas step
        if hasattr(prob, "init_particles"):
            from . import particles as particles_mod
            out.particles = prob.init_particles(par, sim, grid)
            out.par_params = particles_mod.params_from_par(
                par, feedback=par.geti_def("particle", "feedback", 0) > 0)
        return out

    @classmethod
    def from_file(cls, path: str, problem: Optional[str] = None,
                  cmdline=(), **sim_overrides) -> "Simulation":
        par = ParameterDB.from_file(path)
        par.apply_cmdline(cmdline)
        return cls.from_par(par, problem=problem, **sim_overrides)

    @staticmethod
    def _cour(par):
        return par.getd_def("time", "cour_no", 0.8)

    # ------------------------------------------------------------------- step

    def _build_step(self):
        sim, grid, problem = self.sim, self.grid, self.problem
        cour_no, tlim = self.cour_no, self.tlim
        ndim = grid.ndim

        if grid.cylindrical:
            if sim.integrator != "ctu":
                raise NotImplementedError(
                    "cylindrical coordinates: CTU integrator only")
            if sim.mhd and ndim == 3:
                raise NotImplementedError(
                    "cylindrical MHD: 1D (R) and 2D (R,phi) only "
                    "(integrators/cyl.step_mhd1d/step_mhd2d); 3D CT "
                    "pending")
            from .integrators import cyl as integ
        elif sim.integrator == "vl":
            if ndim == 3:
                from .integrators import vl3d as integ
            else:
                from .integrators import vl_lowd as integ
        elif sim.special_relativity:
            raise NotImplementedError(
                "SR requires the VL integrator (integrate_3d_ctu.c:51-53)")
        elif ndim == 1:
            from .integrators import ctu1d as integ
        elif sim.mhd:
            if ndim == 3:
                from .integrators import ctu3d_mhd as integ
            elif ndim == 2:
                from .integrators import ctu2d_mhd as integ
            else:
                raise NotImplementedError
        else:
            from .integrators import ctu3d as integ  # handles 2D and 3D

        userwork = getattr(problem, "userwork_in_loop", None)

        # microphysics coefficients (<problem> block, like the reference's
        # problem-enrolled nu/kappa)
        nu_iso = self.par.getd_def("problem", "nu_iso", 0.0)
        kappa_iso = self.par.getd_def("problem", "kappa_iso", 0.0)
        eta_ohm = self.par.getd_def("problem", "eta_O", 0.0)
        q_ad = self.par.getd_def("problem", "Q_AD", 0.0)
        q_hall = self.par.getd_def("problem", "Q_Hall", 0.0)
        # d_ind present => single-fluid eta_AD = Q_AD*B^2/rho^(1+d_ind)
        # (get_eta.c:110; cshock1d sets d_ind=0); absent => constant Q_AD
        d_ind = (self.par.getd("problem", "d_ind")
                 if self.par.exist("problem", "d_ind") else None)
        nu_aniso = self.par.getd_def("problem", "nu_aniso", 0.0)
        kappa_aniso = self.par.getd_def("problem", "kappa_aniso", 0.0)
        cooling_fn = getattr(problem, "cooling_fn", None)
        has_diff = (nu_iso > 0.0 or kappa_iso > 0.0 or eta_ohm > 0.0
                    or q_ad > 0.0 or q_hall > 0.0 or nu_aniso > 0.0
                    or kappa_aniso > 0.0 or cooling_fn is not None)
        if has_diff:
            from .microphysics import diff_dt as diff_dt_fn, integrate_diff
            eta_ad_max = 0.0
            if q_ad > 0.0 and d_ind is None:
                # constant-coefficient mode: effective eta = Q_AD*B^2
                # bounded by the initial field's maximum; the d_ind
                # (single-fluid) mode recomputes the bound from the
                # state each cycle instead (diff_dt_resistive_state)
                eta_ad_max = q_ad * float(jnp.max(
                    self.state.Bcc[0] ** 2 + self.state.Bcc[1] ** 2
                    + self.state.Bcc[2] ** 2))
            dt_diff = diff_dt_fn(sim, grid, cour_no, nu_iso, kappa_iso,
                                 eta_ohm, eta_ad_max=eta_ad_max,
                                 nu_aniso=nu_aniso,
                                 kappa_aniso=kappa_aniso)

        selfg_pars = None
        if sim.self_gravity:
            from .gravity.selfg import phi_padded
            selfg_pars = (self.par.getd_def("problem", "four_pi_G", 1.0),
                          self.par.getd_def("problem", "grav_mean_rho", 0.0))

        ion = None
        if sim.ion_radplane:
            from .ionrad.config import ion_config_from_par
            from .ionrad.driver import ion_radtransfer
            ion = ion_config_from_par(
                self.par, grid,
                radplanes=getattr(problem, "radplanes", ()),
                time_ramp=getattr(problem, "time_ramp", True))
            self.ion = ion

        # large constant fields travel through jit as arguments (as
        # trace-time constants they would be baked into the executable,
        # hundreds of MB at production sizes)
        dtype = self.state.U.dtype
        if grid.cylindrical:
            from .integrators.cyl import _phi_arrays as _cyl_phi
            phi0 = _cyl_phi(problem, grid, dtype)
        else:
            from .integrators.ctu3d import _phi_arrays
            phi0 = _phi_arrays(problem, grid, dtype) if ndim > 1 else None
        uw_aux0 = (problem.userwork_aux(dtype, sim, grid)
                   if hasattr(problem, "userwork_aux") else None)

        # explicit-halo multichip mode (parallel/overlap.py): on a
        # multi-device mesh the hydro phase runs as shard_map + one
        # ppermute pair per mesh axis over each device's halo-padded
        # block, instead of letting GSPMD insert all-gathers for every
        # stencil shift; static gravity enters through per-shard
        # halo-padded potential blocks (zero extra communication)
        import math as _math
        use_explicit = (
            self.mesh is not None
            and _math.prod(self.mesh.devices.shape) > 1
            and ndim == 3 and not sim.mhd and not grid.cylindrical
            and selfg_pars is None and not sim.fargo
            and not sim.special_relativity and sim.integrator == "ctu")
        phi_halo0 = None
        if use_explicit:
            from .parallel import overlap as _overlap
            phi_halo0 = _overlap.phi_halo_arrays(problem, grid,
                                                 self.mesh, dtype)

        def _apply_bc(st):
            if use_explicit:
                try:
                    return bvals.apply_bc_sharded(st, grid, sim, problem,
                                                  mesh_)
                except AssertionError:
                    pass
            return bvals.apply_bc(st, grid, sim, problem)
        self._step_aux = (phi0, uw_aux0, phi_halo0)
        mesh_ = self.mesh

        # Lagrangian particles run INSIDE the jitted step (the reference
        # integrates them at step 8.5 of the gas integrator,
        # integrate_3d_ctu.c:2283-2291) — one dispatch per cycle
        has_particles = self.particles is not None
        if has_particles:
            from . import particles as particles_mod
            pp = self.par_params
            if use_explicit:
                raise NotImplementedError(
                    "particles on a multi-device mesh: the TSC "
                    "scatter-add is not sharded yet (bvals_particle.c "
                    "MPI path)")
            from .defs import IEN as _IEN, IM1 as _IM1

        def step(state: State, aux=(None, None, None), pts=None):
            phi0, uw_aux = aux[0], aux[1]
            phi_halo = aux[2] if len(aux) > 2 else None
            # dt for this cycle, clipped so we land exactly on tlim
            # (new_dt.c:183-185)
            dt = jnp.minimum(state.dt, jnp.maximum(tlim - state.time, 0.0)
                             ) if tlim > 0 else state.dt

            # operator-split diffusion before radiation/hydro
            # (main.c:530-539); dt clamped to the explicit-diffusion CFL
            if has_diff:
                if (q_ad > 0.0 or q_hall > 0.0) and d_ind is not None:
                    # single-fluid ambipolar: eta_AD is a field of the
                    # evolving B/rho, so the resistive CFL is recomputed
                    # from the state each cycle (diff_dt.c:75-77)
                    from .microphysics.diffusion import \
                        diff_dt_resistive_state
                    dt_diff_t = jnp.minimum(
                        dt_diff, diff_dt_resistive_state(
                            state, sim, grid, cour_no, eta_ohm, q_ad,
                            d_ind, q_hall=q_hall))
                    dt = jnp.minimum(dt, dt_diff_t)
                else:
                    dt = jnp.minimum(dt, dt_diff)
                state = integrate_diff(state, dt, sim, grid, nu_iso,
                                       kappa_iso, cooling_fn,
                                       eta_ohm=eta_ohm, q_ad=q_ad,
                                       nu_aniso=nu_aniso,
                                       kappa_aniso=kappa_aniso,
                                       d_ind=d_ind, q_hall=q_hall)
                state = _apply_bc(state)

            # radiation BEFORE hydro — it may shrink dt (main.c:541-556;
            # ionrad_3d.c:983,1033); ghosts are then refreshed (main.c:552)
            if ion is not None:
                state = state.replace(dt=dt)
                state, dt = ion_radtransfer(state, sim, grid, ion,
                                            state.time, cour_no,
                                            mesh=self.mesh)
                state = _apply_bc(state)

            if has_particles:
                state_n = state
                if pp.feedback:
                    # predictor feedback: subtract the half-step drag
                    # impulse before the gas step and restore it after —
                    # the same time-centering the reference gets from
                    # modifying the L/R states and M*h
                    # (integrate_3d_ctu.c:420-437, 2236-2241); the net
                    # full-step feedback is the corrector's alone
                    fbp, elp = particles_mod.feedback_predictor(
                        pts, state, sim, grid, pp, dt, problem)
                    U = state.U.at[_IM1:_IM1 + 3].add(-fbp)
                    if sim.adiabatic:
                        U = U.at[_IEN].add(elp)
                    # fbp is ghost-folded (zero ghosts): refresh the
                    # ghost zones so the integrator sees no boundary
                    # jump in the kicked momenta
                    state = _apply_bc(state.replace(U=U))

            if selfg_pars is not None:
                # Phi from rho at t^n (the reference solves at the end of
                # the previous cycle, main.c:603-613 — same potential)
                phi_sg = phi_padded(state, sim, grid, *selfg_pars)
                state, fluxes = integ.step(state, dt, sim, grid, problem,
                                           phi_sg=phi_sg,
                                           selfg_pars=selfg_pars,
                                           return_fluxes=True, phi=phi0)
            elif use_explicit:
                from .parallel import overlap as _ovl
                state = _ovl.hydro_step_sharded_grav(
                    state, dt, sim, grid, mesh_, phi_halo=phi_halo)
            else:
                state = integ.step(state, dt, sim, grid, problem,
                                   phi=phi0)

            if has_particles:
                if pp.feedback:
                    # restore the predictor impulse (constant arrays:
                    # exact bookkeeping), leaving only its effect on the
                    # time-centered fluxes
                    U = state.U.at[_IM1:_IM1 + 3].add(fbp)
                    if sim.adiabatic:
                        U = U.at[_IEN].add(-elp)
                    state = state.replace(U=U)
                # valid ghosts for the TSC drag gather of near-boundary
                # particles (the final _apply_bc runs after this block)
                state = _apply_bc(state)
                # drag vs the old/new average — 2nd-order equivalent of
                # the reference's Coup.grid_v at t^{n+1/2}, which
                # INCLUDES the predictor impulse (M1h -= fb1,
                # integrate_3d_ctu.c:2236-2281)
                Uh = 0.5 * (state.U + state_n.U)
                if pp.feedback:
                    Uh = Uh.at[_IM1:_IM1 + 3].add(-fbp)
                half = _apply_bc(state.replace(U=Uh))
                pts, fb, eloss = particles_mod.integrate(
                    pts, state, dt, sim, grid, pp, problem,
                    drag_state=half)
                if fb is not None:
                    # corrector feedback at the final update
                    # (integrate_3d_ctu.c:2957-2973)
                    U = state.U.at[_IM1:_IM1 + 3].add(-fb)
                    if sim.adiabatic:
                        U = U.at[_IEN].add(eloss)
                    state = state.replace(U=U)

            if sim.fargo:
                # orbital advection right after the integrator
                # (main.c:576-583)
                from .shearing import fargo_advect
                state = fargo_advect(state, sim, grid, dt)

            if userwork is not None:
                if uw_aux is not None:
                    state = userwork(state, sim, grid, aux=uw_aux)
                else:
                    state = userwork(state, sim, grid)

            if selfg_pars is not None:
                # new Phi from the updated rho + the 2nd-order old/new-Phi
                # flux correction (main.c:603-613 -> selfg.c:selfg_fc)
                from .gravity.selfg import selfg_fc
                phi_new = phi_padded(state, sim, grid, *selfg_pars)
                mflux = {a: F[0] for a, F in fluxes.items()}
                U = selfg_fc(state.U, phi_new, phi_sg, mflux, dt, sim,
                             grid, *selfg_pars)
                sl = (slice(None),) + grid.interior()
                state = state.replace(U=state.U.at[sl].set(U[sl]))

            state = state.replace(time=state.time + dt,
                                  nstep=state.nstep + 1,
                                  dt=dt)
            dt_next = dt_mod.new_dt(state, sim, grid, cour_no)
            if has_particles:
                # particle CFL (new_dt.c:143-153; |v| rather than the
                # reference's signed max)
                for a in range(3):
                    if grid.active(a):
                        vmax = jnp.max(jnp.abs(
                            jnp.where(pts.alive, pts.v[a], 0.0)))
                        dt_next = jnp.minimum(
                            dt_next,
                            cour_no * grid.dx[a] / jnp.maximum(vmax,
                                                               1e-30))
            state = state.replace(dt=dt_next)
            state = _apply_bc(state)
            if has_particles:
                return state, pts
            return state

        return jax.jit(step)

    def step(self):
        if self._jit_step is None:
            self._jit_step = self._build_step()
        if self.particles is not None:
            self.state, self.particles = self._jit_step(
                self.state, self._step_aux, self.particles)
        else:
            self.state = self._jit_step(self.state, self._step_aux)

    # -------------------------------------------------------------------- run

    def make_outputs(self, outdir: str = "."):
        """Build the <outputN> dispatcher (init_output analogue)."""
        from .io.outputs import OutputSet
        return OutputSet(self.par, outdir)

    def run(self, max_steps: Optional[int] = None, verbose: bool = False,
            output_fn=None, outdir: Optional[str] = None):
        """Main loop (main.c:519-669).  output_fn(sim) is called before each
        step and once at the end (data_output analogue); passing `outdir`
        instead builds the deck's <outputN> dispatcher automatically."""
        if output_fn is None and outdir is not None:
            outs = self.make_outputs(outdir)
            output_fn = lambda s: outs(s)
        nlim = self.nlim if max_steps is None else max_steps
        t0 = _time.perf_counter()
        zones = int(np.prod([n for n in self.grid.Nx]))
        steps0 = int(self.state.nstep)
        while True:
            tnow = float(self.state.time)
            nstep = int(self.state.nstep)
            if self.tlim > 0 and tnow >= self.tlim:
                break
            if nlim is not None and nlim >= 0 and nstep - steps0 >= nlim:
                break
            if output_fn is not None:
                output_fn(self)
            if verbose:
                print(f"cycle={nstep} time={tnow:.6e} dt="
                      f"{float(self.state.dt):.6e}")
            self.step()
        jax.block_until_ready(self.state.U)
        wall = _time.perf_counter() - t0
        nsteps = int(self.state.nstep) - steps0
        if output_fn is not None:
            output_fn(self)
        zcps = zones * nsteps / wall if wall > 0 else float("nan")
        if verbose:
            print(f"zone-cycles/wall-second = {zcps:.3e}")
        return dict(steps=nsteps, wall=wall, zone_cycles_per_sec=zcps)
