"""Static-mesh-refinement simulation driver: the MeshS->DomainS hierarchy
(reference: src/main.c main loop with SMR, src/init_mesh.c <domainN>
parsing).

A MeshSimulation holds one Simulation-like level state per <domainN> block
(refinement ratio 2, one Domain per level — the linear chain used by the
production deck tst/massloss/athinput.ioniz_sphere_hires).  Each cycle runs
the reference's SMR ordering (main.c:519-669):

  radiation (root sets tcoarse; fine levels integrate to it with the
  parent's EdgeFlux as inlet)  ->  ionradRestrictCorrect  ->  hydro on
  every level with the same dt  ->  RestrictCorrect (conserved restriction
  + fine/coarse flux correction)  ->  Userwork  ->  new_dt (min over
  levels, 2x growth clamp)  ->  bvals (root; children are fully interior
  so every face is ProlongateLater)  ->  Prolongate (child ghost fill).
"""

from __future__ import annotations

from typing import List, Optional

import jax
import jax.numpy as jnp

from . import bvals, smr
from . import dt as dt_mod
from .config import (GridConfig, SimConfig, grid_config_from_par,
                     sim_config_from_par)
from .defs import IEN
from .models import get_problem
from .par import ParameterDB
from .state import State


class Level:
    def __init__(self, grid: GridConfig, state: State, problem,
                 link: Optional[smr.ChildLink], lev: int = 0,
                 parent: Optional[int] = None):
        self.grid = grid
        self.state = state
        self.problem = problem
        self.link = link      # overlap with the parent (None for root)
        self.lev = lev
        self.parent = parent  # index into the Level list (None for root)


def grids_from_par(par: ParameterDB):
    """Parse all <domainN> blocks -> [(level, GridConfig, disp, parent)].

    iDisp/jDisp/kDisp are measured in cells OF THIS LEVEL from the ROOT
    origin (init_mesh.c:375-394: MinX = root_xmin + Disp*dx_own, with the
    Disp==0 / touches-root-boundary cases snapped exactly to the root
    box).  The parent is found by spatial containment of the child's
    index box at level-1 resolution (init_mesh.c:424-446) — the general
    DomainS[nlevel][ndomain] tree, not a one-domain-per-level chain."""
    doms = []
    root = grid_config_from_par(par)   # domain1
    doms.append((0, root, (0, 0, 0), None))
    n = 2
    while par.exist(f"domain{n}", "level"):
        blk = f"domain{n}"
        lev = par.geti(blk, "level")
        Nx = tuple(par.geti_def(blk, f"Nx{a + 1}", 1) for a in range(3))
        disp = (par.geti_def(blk, "iDisp", 0),
                par.geti_def(blk, "jDisp", 0),
                par.geti_def(blk, "kDisp", 0))
        irefine = 2 ** lev
        xmin, xmax = [], []
        for a in range(3):
            if not root.active(a):
                xmin.append(root.xmin[a])
                xmax.append(root.xmax[a])
                continue
            dxo = root.dx[a] / irefine
            lo = (root.xmin[a] if disp[a] == 0
                  else root.xmin[a] + disp[a] * dxo)
            izones = (disp[a] + Nx[a]) // irefine
            hi = (root.xmax[a] if izones == root.Nx[a]
                  else lo + Nx[a] * dxo)
            xmin.append(lo)
            xmax.append(hi)
        # parent: the level-1 domain whose index box contains this child's
        # box coarsened to the parent level
        pidx = None
        for i, (plev, pg, pdisp, _) in enumerate(doms):
            if plev != lev - 1:
                continue
            if all((not root.active(a))
                   or (pdisp[a] <= disp[a] // 2
                       and (disp[a] + Nx[a]) // 2 <= pdisp[a] + pg.Nx[a])
                   for a in range(3)):
                pidx = i
                break
        if pidx is None:
            raise ValueError(f"<{blk}>: no level-{lev - 1} domain "
                             f"contains it (disp={disp}, Nx={Nx})")
        doms.append((lev, GridConfig(Nx=Nx, xmin=tuple(xmin),
                                     xmax=tuple(xmax), bc=root.bc),
                     disp, pidx))
        n += 1
    return doms


def _bytes_limit():
    """Device memory JAX may allocate on the first device; None on a
    device that reports no limit (the CPU)."""
    return (jax.devices()[0].memory_stats() or {}).get("bytes_limit")


class MeshSimulation:
    """Multi-level SMR driver.  API mirrors Simulation (step/run/state)."""

    def __init__(self, par: ParameterDB, sim: SimConfig,
                 levels: List[Level]):
        self.par = par
        self.sim = sim
        self.levels = levels
        self.cour_no = par.getd_def("time", "cour_no", 0.8)
        self.tlim = par.getd_def("time", "tlim", 1.0)
        self.nlim = par.geti_def("time", "nlim", -1)
        self._jit_step = None
        # set by the first step(): whether the cycle runs phased, and the
        # compiled whole cycle's peak bytes that decided it
        self.phased, self.whole_peak_bytes = False, None

    # ------------------------------------------------------------------
    @classmethod
    def from_par(cls, par: ParameterDB, problem=None, **overrides):
        from .simulation import Simulation, parse_configure_line
        auto = parse_configure_line(par)
        problem = problem or auto.pop("_problem", None)
        auto.pop("_problem", None)
        prob_cls = get_problem(problem)
        for k, v in getattr(prob_cls, "sim_overrides", {}).items():
            auto.setdefault(k, v)
        auto.update(overrides)
        sim = sim_config_from_par(par, **auto)
        doms = grids_from_par(par)
        levels = []
        for (lev, grid, disp, pidx) in doms:
            prob = prob_cls(par, sim, grid)
            st = prob.init(par, sim, grid)
            link = None
            if lev > 0:
                link = smr.child_link(doms[pidx][1], grid, disp,
                                      doms[pidx][2])
            levels.append(Level(grid, st, prob, link, lev=lev,
                                parent=pidx))
        # child-before-parent / parent-before-child orderings over the
        # general tree (deepest level first / last)
        down = sorted(range(1, len(levels)),
                      key=lambda i: -levels[i].lev)
        up = sorted(range(1, len(levels)), key=lambda i: levels[i].lev)

        # startup (main.c:400-446): RestrictCorrect with zeroed fluxes —
        # i.e. pure restriction of U (+ interior faces and Bcc for MHD;
        # the boundary-plane faces stay, their flux correction is a
        # no-op) — then bvals, then Prolongate
        for li in down:
            p, c = levels[levels[li].parent], levels[li]
            p.state = p.state.replace(U=smr.restrict_to_parent(
                p.state.U, c.state.U, p.grid, c.grid, c.link))
            if sim.mhd:
                from . import smr_fld
                Bcp = smr.restrict_to_parent(
                    p.state.Bcc, c.state.Bcc, p.grid, c.grid, c.link)
                B1, B2, B3, Bcp = smr_fld.restrict_fld(
                    p.state.B1i, p.state.B2i, p.state.B3i, Bcp,
                    c.state.B1i, c.state.B2i, c.state.B3i,
                    p.grid, c.grid, c.link)
                p.state = p.state.replace(Bcc=Bcp, B1i=B1, B2i=B2,
                                          B3i=B3)
        levels[0].state = bvals.apply_bc(levels[0].state, levels[0].grid,
                                         sim, levels[0].problem)
        for li in up:
            p, c = levels[levels[li].parent], levels[li]
            c.state = c.state.replace(U=smr.prolong_ghosts(
                p.state.U, c.state.U, p.grid, c.grid, c.link, sim=sim,
                Bccc=p.state.Bcc if sim.mhd else None))
            if sim.mhd:
                from . import smr_fld
                B1, B2, B3, Bcc = (c.state.B1i, c.state.B2i,
                                   c.state.B3i, c.state.Bcc)
                for dim, region in smr_fld.ghost_regions(c.grid):
                    B1, B2, B3, Bcc = smr_fld.prolong_fld(
                        B1, B2, B3, Bcc, p.state.B1i, p.state.B2i,
                        p.state.B3i, p.grid, c.grid, c.link, region,
                        dim)
                c.state = c.state.replace(Bcc=Bcc, B1i=B1, B2i=B2,
                                          B3i=B3)
        dt0 = jnp.asarray(
            min(float(dt_mod.new_dt(l.state, sim, l.grid,
                                    par.getd_def("time", "cour_no", 0.8)))
                for l in levels), levels[0].state.U.dtype)
        for l in levels:
            l.state = l.state.replace(dt=dt0)
        return cls(par, sim, levels)

    # ------------------------------------------------------------------
    @property
    def state(self):      # root-level view (time/dt/nstep live here)
        return self.levels[0].state

    def _build_step(self, phased: bool = False):
        """Build the cycle function.

        phased=False jits the whole multi-level cycle as ONE program —
        lowest overhead, but XLA's peak allocation spans every level's
        integrator temporaries at once.  phased=True (chosen when the
        whole cycle would not fit in device memory, see _choose_step)
        keeps the cycle as a host loop over per-level jitted pieces so
        device memory peaks at one level's working set; inter-level glue
        (inlet slabs, dt min) runs eagerly on tiny arrays.
        """
        sim = self.sim
        cour_no, tlim = self.cour_no, self.tlim
        levels = self.levels
        nlev = len(levels)
        grids = [l.grid for l in levels]
        probs = [l.problem for l in levels]
        links = [l.link for l in levels]
        parents = [l.parent for l in levels]
        down = sorted(range(1, nlev), key=lambda i: -levels[i].lev)
        up = sorted(range(1, nlev), key=lambda i: levels[i].lev)

        jits = {}

        def sync(st):
            # phased mode: block until this level's phase has executed
            # before dispatching the next — with a deep async queue the
            # runtime allocates every phase's outputs up front, which
            # would undo the memory bound phased mode exists for
            if phased:
                jax.block_until_ready(st)
            return st

        def J(key, fn, donate=None):
            # cached per-level jit boundaries; under the whole-cycle jit
            # (phased=False) these inline into the outer trace.
            # donate: argnums whose buffers the phase may reuse (phased
            # mode only — a 320^3 f32 level state is 850 MB)
            if key not in jits:
                if donate is not None and phased:
                    jits[key] = jax.jit(fn, donate_argnums=donate)
                else:
                    jits[key] = jax.jit(fn)
            return jits[key]

        ion = None
        if sim.ion_radplane:
            from .ionrad.config import ion_config_from_par
            from .ionrad.driver import ion_radtransfer
            ions = [ion_config_from_par(
                self.par, g, radplanes=getattr(p, "radplanes", ()),
                time_ramp=getattr(p, "time_ramp", True))
                for g, p in zip(grids, probs)]
            direction = ions[0].radplanes[0][0]

        if sim.integrator != "ctu":
            raise NotImplementedError("SMR driver uses the CTU integrator")
        from .integrators import ctu3d
        if sim.mhd:
            if sim.ion_radplane:
                raise NotImplementedError("SMR radiation is hydro-only")
            from . import smr_fld
            from .integrators import ctu2d_mhd, ctu3d_mhd

        def integ_step(li):
            if not sim.mhd:
                return ctu3d.step
            return (ctu3d_mhd if grids[li].ndim == 3 else ctu2d_mhd).step

        def bflux(FByz, a):
            """Cell-centered B flux rows for the conserved flux
            correction (myFlx .B1c/.B2c/.B3c, integrate_3d_ctu.c
            :3100-3102, :3147-3149, :3194-3195); normal component 0."""
            z = jnp.zeros_like(FByz[a][0])
            rows = {0: lambda: [z, FByz[0][0], FByz[0][1]],
                    1: lambda: [FByz[1][1], z, FByz[1][0]],
                    2: lambda: [FByz[2][0], FByz[2][1], z]}[a]()
            return jnp.stack(rows)

        # per-level constant fields travel as jit arguments (as trace-time
        # constants they would be baked into the executable, hundreds of MB
        # at hires size)
        dtype = levels[0].state.U.dtype
        self._step_aux = [
            (ctu3d._phi_arrays(p_, g, dtype),
             p_.userwork_aux(dtype, sim, g)
             if hasattr(p_, "userwork_aux") else None)
            for g, p_ in zip(grids, probs)]

        def step(states, auxs):
            dt = states[0].dt
            if tlim > 0:
                dt = jnp.minimum(dt, jnp.maximum(tlim - states[0].time,
                                                 0.0))
            time = states[0].time

            # --- radiation: root first (sets dt & tcoarse), then fine
            # levels to tcoarse with the parent EdgeFlux inlet
            # (main.c:541-556; ionrad_3d.c:836-852, 914-962)
            def run_rad(li, st, t, inl, tc):
                # root (li==0): inl/tc are None and dt feeds the mesh
                if inl is None:
                    return J(("rad", li), lambda s, t_, _li=li:
                             ion_radtransfer(s, sim, grids[_li], ions[_li],
                                             t_, cour_no))(st, t)
                return J(("radc", li), lambda s, t_, i_, c_, _li=li:
                         ion_radtransfer(s, sim, grids[_li], ions[_li], t_,
                                         cour_no, inlet=i_, tcoarse=c_))(
                                             st, t, inl, tc)

            if sim.ion_radplane:
                states = [s.replace(dt=dt) for s in states]
                s0, dt = run_rad(0, states[0], time, None, None)
                states[0] = s0
                tcoarse = dt
                for li in up:
                    pi = parents[li]
                    inlet = J(("inlet", li),
                              lambda E, _li=li, _pi=pi:
                              smr.child_inlet_flux(
                                  E, grids[_pi], grids[_li],
                                  links[_li], direction))(
                                      states[pi].Eflux)
                    sl, _ = run_rad(li, states[li], time, inlet,
                                    tcoarse)
                    states[li] = sync(sl)
                # ionradRestrictCorrect: E and s0 fine -> coarse
                iscal = 5 if sim.adiabatic else 4
                for li in down:
                    pi = parents[li]
                    states[pi] = states[pi].replace(
                        U=J(("radrestrict", li),
                            lambda Up, Uc, _li=li, _pi=pi:
                            smr.restrict_to_parent(
                                Up, Uc, grids[_pi], grids[_li],
                                links[_li], nvars=[IEN, iscal]))(
                                    states[pi].U, states[li].U))

            # --- hydro/MHD on every level with the same dt.  Each
            # level's jit returns ONLY the boundary-plane fluxes/EMFs
            # the corrections need (pCO/pPO myFlx+myEMF,
            # integrate_3d_ctu.c:3060-3330) — never the full flux
            # cubes, whose three 320^3 copies alone are 2.5 GB
            children = {li: [c for c in range(1, nlev)
                             if parents[c] == li] for li in range(nlev)}
            planes = []
            new_states = []
            for li in range(nlev):
                # U travels apart from the rest of the state so phased mode
                # donates only U: the levels share their time/dt/nstep
                # buffers
                def hyd(U, s, d, phi_, _li=li):
                    out = integ_step(_li)(s.replace(U=U), d, sim, grids[_li],
                                          probs[_li], return_fluxes=True,
                                          phi=phi_)
                    if sim.mhd:
                        snew, (FU, FByz, emfs) = out
                        FB = {a: bflux(FByz, a) for a in FU}
                    else:
                        snew, FU = out
                        FB, emfs = None, None
                    pk = {}
                    if parents[_li] is not None:
                        pk["own"] = {
                            "U": smr.boundary_flux_planes_fine(
                                FU, grids[_li])}
                        if sim.mhd:
                            pk["own"]["B"] = \
                                smr.boundary_flux_planes_fine(
                                    FB, grids[_li])
                            pk["own"]["E"] = smr_fld.emf_planes_fine(
                                emfs, grids[_li])
                    for ci in children[_li]:
                        cp = {"U": smr.boundary_flux_planes_coarse(
                            FU, grids[_li], links[ci])}
                        if sim.mhd:
                            cp["B"] = smr.boundary_flux_planes_coarse(
                                FB, grids[_li], links[ci])
                            cp["E"] = smr_fld.emf_planes_coarse(
                                emfs, grids[_li], links[ci])
                        pk[f"child{ci}"] = cp
                    return snew, pk
                snew, pk = J(("hydro", li), hyd, donate=(0,))(
                    states[li].U, states[li].replace(U=None), dt,
                    auxs[li][0])
                new_states.append(sync(snew))
                planes.append(pk)
            states = new_states

            # --- RestrictCorrect: conserved restriction + flux correction
            # (+ face restriction and EMF correction for MHD,
            # smr.c:1207-1890)
            for li in down:
                pi = parents[li]
                cpl = planes[pi][f"child{li}"]
                fpl = planes[li]["own"]
                if sim.mhd:
                    def corr_mhd(ps, cs, cpl_, fpl_, d, _li=li, _pi=pi):
                        pg, fg, lk = grids[_pi], grids[_li], links[_li]
                        Up = smr.restrict_to_parent(ps.U, cs.U, pg, fg,
                                                    lk)
                        Bcp = smr.restrict_to_parent(ps.Bcc, cs.Bcc, pg,
                                                     fg, lk)
                        Up = smr.flux_correct_planes(
                            Up, cpl_["U"], fpl_["U"], pg, fg, lk, d)
                        Bcp = smr.flux_correct_planes(
                            Bcp, cpl_["B"], fpl_["B"], pg, fg, lk, d)
                        B1, B2, B3, Bcp = smr_fld.restrict_fld(
                            ps.B1i, ps.B2i, ps.B3i, Bcp,
                            cs.B1i, cs.B2i, cs.B3i, pg, fg, lk)
                        B1, B2, B3, Bcp = smr_fld.emf_correct_planes(
                            B1, B2, B3, Bcp, cpl_["E"], fpl_["E"],
                            pg, fg, lk, d)
                        return ps.replace(U=Up, Bcc=Bcp, B1i=B1,
                                          B2i=B2, B3i=B3)
                    states[pi] = sync(J(("correct", li), corr_mhd)(
                        states[pi], states[li], cpl, fpl, dt))
                else:
                    Up = J(("correct", li),
                           lambda Up_, Uc, cpl_, fpl_, d, _li=li,
                           _pi=pi:
                           smr.flux_correct_planes(
                               smr.restrict_to_parent(
                                   Up_, Uc, grids[_pi], grids[_li],
                                   links[_li]),
                               cpl_["U"], fpl_["U"], grids[_pi],
                               grids[_li], links[_li],
                               d))(states[pi].U, states[li].U,
                                   cpl, fpl, dt)
                    states[pi] = sync(states[pi].replace(U=Up))
            planes = None

            # --- Userwork (prob/ioniz_sphere.c:255-306 core reset)
            for li in range(nlev):
                uw = getattr(probs[li], "userwork_in_loop", None)
                if uw is not None:
                    if auxs[li][1] is not None:
                        states[li] = J(("uw", li),
                                       lambda s, aux_, _li=li, _uw=uw:
                                       _uw(s, sim, grids[_li],
                                           aux=aux_))(
                                               states[li], auxs[li][1])
                    else:
                        states[li] = J(("uw", li),
                                       lambda s, _li=li, _uw=uw:
                                       _uw(s, sim, grids[_li]))(
                                           states[li])

            # --- time/dt update: min over levels, 2x clamp
            # (new_dt.c:32-198 loops all Grids)
            dts = [J(("dt", li),
                     lambda s, _li=li: dt_mod.new_dt(
                         s, sim, grids[_li], cour_no))(
                             states[li].replace(dt=dt))
                   for li in range(nlev)]
            dt_next = dts[0]
            for d2 in dts[1:]:
                dt_next = jnp.minimum(dt_next, d2)

            time = time + dt
            states = [s.replace(time=time, dt=dt_next,
                                nstep=states[0].nstep + 1)
                      for s in states]

            # --- boundary values (root physical BCs; children interior)
            states[0] = J(("bc", 0), lambda s: bvals.apply_bc(
                s, grids[0], sim, probs[0]))(states[0])

            # --- Prolongate: child ghost zones from the parent
            for li in up:
                pi = parents[li]
                if sim.mhd:
                    def prol_mhd(ps, cs, _li=li, _pi=pi):
                        pg, fg, lk = grids[_pi], grids[_li], links[_li]
                        U = smr.prolong_ghosts(ps.U, cs.U, pg, fg,
                                               lk, sim=sim,
                                               Bccc=ps.Bcc)
                        B1, B2, B3, Bcc = (cs.B1i, cs.B2i, cs.B3i,
                                           cs.Bcc)
                        for dim, region in smr_fld.ghost_regions(fg):
                            B1, B2, B3, Bcc = smr_fld.prolong_fld(
                                B1, B2, B3, Bcc, ps.B1i, ps.B2i,
                                ps.B3i, pg, fg, lk, region, dim)
                        return cs.replace(U=U, Bcc=Bcc, B1i=B1, B2i=B2,
                                          B3i=B3)
                    states[li] = sync(J(("prolong", li), prol_mhd)(
                        states[pi], states[li]))
                else:
                    states[li] = states[li].replace(
                        U=J(("prolong", li),
                            lambda Up, Uc, _li=li, _pi=pi:
                            smr.prolong_ghosts(
                                Up, Uc, grids[_pi], grids[_li],
                                links[_li], sim=sim))(states[pi].U,
                                                      states[li].U))
                    states[li] = sync(states[li])
            return states

        return step if phased else jax.jit(step)

    # headroom kept between the compiled whole cycle's peak and the
    # device's limit: the 256^3 uniform step's peak_bytes_in_use was 1.007x
    # its memory_analysis() on an NVIDIA H100 80GB HBM3 (700 W)
    PEAK_MARGIN = 1.25

    def _choose_step(self, states):
        """The whole cycle as one compiled program when its peak, with
        PEAK_MARGIN, fits the device's memory; the phased cycle otherwise.
        A device that reports no limit (the CPU) runs the whole cycle and
        compiles nothing here."""
        whole = self._build_step(phased=False)
        limit = _bytes_limit()
        self.phased, self.whole_peak_bytes = False, None
        if not limit:
            return whole
        ma = whole.lower(states, self._step_aux).compile().memory_analysis()
        # the jit reuses this executable on its first call
        self.whole_peak_bytes = (ma.argument_size_in_bytes
                                 + ma.output_size_in_bytes
                                 + ma.temp_size_in_bytes
                                 - ma.alias_size_in_bytes)
        if self.whole_peak_bytes * self.PEAK_MARGIN <= limit:
            return whole
        self.phased = True
        return self._build_step(phased=True)

    def step(self):
        states = [l.state for l in self.levels]
        if self._jit_step is None:
            self._jit_step = self._choose_step(states)
        new_states = self._jit_step(states, self._step_aux)
        for l, s in zip(self.levels, new_states):
            l.state = s

    # ------------------------------------------------------------------
    class _LevelView:
        """Simulation-shaped view of one level for the output writers."""

        def __init__(self, mesh, li):
            l = mesh.levels[li]
            self.par = mesh.par
            self.sim = mesh.sim
            self.grid = l.grid
            self.state = l.state
            self.problem = l.problem

    def make_outputs(self, outdir: str = "."):
        """Per-(level,domain) output sets, files under lev#/ with -lev#
        problem_id suffixes like ath_fname (src/ath_files.c)."""
        import os as _os
        from .io.outputs import OutputSet
        pid = self.par.gets_def("job", "problem_id", "out")
        sets = []
        for li in range(len(self.levels)):
            d = outdir if li == 0 else _os.path.join(outdir, f"lev{li}")
            p = pid if li == 0 else f"{pid}-lev{li}"
            sets.append(OutputSet(self.par, d, problem_id=p))
        mesh = self

        def write(_sim_obj=None, force=False):
            for li, outs in enumerate(sets):
                outs(MeshSimulation._LevelView(mesh, li), force=force)
        return write

    def run(self, max_steps=None, verbose=False, output_fn=None,
            outdir=None):
        import time as _time

        import numpy as _np
        if output_fn is None and outdir is not None:
            outs = self.make_outputs(outdir)
            output_fn = lambda s: outs(s)
        nlim = self.nlim if max_steps is None else max_steps
        t0 = _time.perf_counter()
        zones = sum(int(_np.prod(l.grid.Nx)) for l in self.levels)
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
