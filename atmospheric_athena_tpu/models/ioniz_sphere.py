"""Photoevaporating hot-Jupiter atmosphere — THE production problem
(reference: src/prob/ioniz_sphere.c).

Polytropic (P = K·rho^Gamma) planet atmosphere in hydrostatic balance in the
planet's gravity, irradiated by a plane-parallel ionizing flux entering on
the -x1 edge; static potential = planet + star + centrifugal (PlanetPot,
ioniz_sphere.c:316-330); every cycle the profile inside r < 0.75·rp is
re-imposed (Userwork_in_loop, :255-306)."""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from .. import state as state_mod
from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1, TINY_NUMBER
from . import register


@register("ioniz_sphere")
class IonizSphere:
    sim_overrides = dict(ion_radiation=True, ion_radplane=True, nscalars=1,
                         h_correction=True)

    def __init__(self, par, sim: SimConfig, grid: GridConfig):
        self.par = par
        gamma, g1 = sim.gamma, sim.gamma_1
        mu = par.getd("ionradiation", "mu")
        self.flux = par.getd("problem", "flux")
        cs = par.getd("problem", "cs")
        rp = par.getd_def("problem", "rp", 1.2e10)
        mp = par.getd_def("problem", "mp", 1.0e30)
        np_ = par.getd_def("problem", "np", 6.0e8)
        Ggrav = 6.67e-8
        self.GM = Ggrav * mp
        rhop = np_ * mu
        self.Rsoft = 0.01 * rp
        self.rp = rp
        self.rin = 0.5 * rp
        self.rreset2 = 0.5625 * rp * rp
        self.powindex = 1.0 / g1
        self.K = rhop ** (-g1) * cs * cs
        # central/reset density and integration constant (:93-96)
        self.rho0 = (rhop ** g1 - g1 / gamma * self.GM / self.K *
                     (1.0 / rp - 1.0 / self.rin)) ** self.powindex
        self.Cp = self.rho0 ** g1 - (g1 / gamma) * self.GM / self.K / self.rin
        rhoedge = rhop / 10.0
        self.rout = 1.0 / (gamma / g1 / self.GM * self.K *
                           (rhoedge ** g1 - self.rho0 ** g1) + 1.0 / self.rin)
        self.rhoedge = rhoedge
        self.rhoout = rhoedge / 10000.0
        self.radplanes = [(-1, self.flux)]
        self.time_ramp = True
        if par.geti_def("problem", "nradplanes", 1) != 1:
            raise ValueError("exactly one radplane supported "
                             "(ioniz_sphere.c:144-160)")

    # -- static gravity: planet + star + centrifugal (PlanetPot, :316-330) --
    def static_grav_pot(self, x1, x2, x3):
        rad = jnp.sqrt(x1 ** 2 + x2 ** 2 + x3 ** 2)
        adist = 7.48e11
        GMstar = 6.67e-8 * 1.99e33
        omega = math.sqrt(GMstar / adist ** 3)
        radstar = jnp.sqrt((x1 + adist) ** 2 + x2 ** 2 + x3 ** 2)
        rcentrif2 = (x1 + adist) ** 2 + x2 ** 2
        return (-self.GM / (rad + self.Rsoft) - GMstar / radstar
                - 0.5 * omega ** 2 * rcentrif2)

    def init(self, par, sim: SimConfig, grid: GridConfig):
        st = state_mod.zeros(sim, grid)
        gamma, g1 = sim.gamma, sim.gamma_1

        xs = [np.asarray(grid.cc_coords(a)) for a in range(3)]
        x1 = jnp.asarray(xs[0]).reshape(1, 1, -1)
        x2 = jnp.asarray(xs[1]).reshape(1, -1, 1)
        x3 = jnp.asarray(xs[2]).reshape(-1, 1, 1)
        rad = jnp.sqrt(x1 ** 2 + x2 ** 2 + x3 ** 2)
        rad = jnp.broadcast_to(rad, grid.padded_shape()).astype(st.U.dtype)

        prof = (g1 / gamma * self.GM / self.K /
                jnp.maximum(rad, TINY_NUMBER) + self.Cp) ** self.powindex
        d = jnp.where(rad <= self.rin, self.rho0,
                      jnp.where(rad > self.rout, self.rhoout, prof))
        E = jnp.where(rad > self.rout,
                      self.K * self.rhoedge ** gamma / g1,
                      self.K * d ** gamma / g1)
        s0 = jnp.where(rad > self.rout, d * 1.0e-4, d)

        U = st.U.at[ID].set(d)
        U = U.at[IEN].set(E)
        U = U.at[5].set(s0)
        return st.replace(U=U)

    def _reset_fields(self, dtype, sim: SimConfig, grid: GridConfig):
        """Precomputed (inside-mask, reset-rho, reset-E) for userwork — these
        depend only on the grid, so build them once on the host (numpy) and
        cache; the per-cycle userwork is then six jnp.where ops."""
        key = (str(dtype), grid.padded_shape())
        cached = getattr(self, "_reset_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        import jax
        with jax.ensure_compile_time_eval():
            return self._reset_build(key, dtype, sim, grid)

    def _reset_build(self, key, dtype, sim, grid):
        gamma, g1 = sim.gamma, sim.gamma_1
        xs = [np.asarray(grid.cc_coords(a)) for a in range(3)]
        x1 = xs[0].reshape(1, 1, -1)
        x2 = xs[1].reshape(1, -1, 1)
        x3 = xs[2].reshape(-1, 1, 1)
        rad2 = np.broadcast_to(x1 ** 2 + x2 ** 2 + x3 ** 2,
                               grid.padded_shape()).astype(dtype)
        inside = rad2 <= self.rreset2
        # only active cells (is..ie loops)
        act = np.zeros(grid.padded_shape(), bool)
        act[grid.interior()] = True
        inside = inside & act

        # the reset sphere covers O(0.1%) of the flagship grid: restrict
        # the per-cycle update to the mask's static bounding box so
        # userwork costs a small dynamic-update-slice, not a full-grid
        # select over six fields (same values, same cells)
        if inside.any():
            zi, yi, xi = np.where(inside)
            bbox = (slice(int(zi.min()), int(zi.max()) + 1),
                    slice(int(yi.min()), int(yi.max()) + 1),
                    slice(int(xi.min()), int(xi.max()) + 1))
        else:
            bbox = (slice(0, 1), slice(0, 1), slice(0, 1))

        with np.errstate(invalid="ignore", over="ignore",
                         divide="ignore"):
            myrho = (g1 / gamma * self.GM / self.K /
                     np.maximum(np.sqrt(rad2), TINY_NUMBER)
                     + self.Cp) ** self.powindex
            myrho = np.minimum(myrho, self.rho0).astype(dtype)
            myE = (self.K * myrho ** gamma / g1).astype(dtype)
        # bbox is jit-static: it lives in a host-side cache (keyed like
        # the aux) rather than riding the traced aux tuple
        if not hasattr(self, "_bbox_cache"):
            self._bbox_cache = {}
        self._bbox_cache[key] = bbox
        out = (jnp.asarray(inside[bbox]),
               jnp.asarray(myrho[bbox]), jnp.asarray(myE[bbox]))
        self._reset_cache = (key, out)
        return out

    def userwork_aux(self, dtype, sim: SimConfig, grid: GridConfig):
        """Constant fields for userwork_in_loop, exposed so drivers can
        pass them through jit as arguments (as trace-time constants they
        would be baked into the executable at production sizes)."""
        return self._reset_fields(dtype, sim, grid)

    def userwork_in_loop(self, state, sim: SimConfig, grid: GridConfig,
                         aux=None):
        """Re-impose the hydrostatic profile within r < 0.75 rp each cycle
        (Userwork_in_loop, ioniz_sphere.c:283-293)."""
        inside, myrho, myE = (
            aux if aux is not None else
            self._reset_fields(state.U.dtype, sim, grid))
        key = (str(state.U.dtype), grid.padded_shape())
        if not hasattr(self, "_bbox_cache") or key not in self._bbox_cache:
            self._reset_fields(state.U.dtype, sim, grid)
        bbox = self._bbox_cache[key]

        # one dynamic-update-slice over the mask's static bounding box:
        # stack the reset values per variable and select within the box
        U = state.U
        sub = U[(slice(None),) + bbox]
        zero = jnp.zeros_like(myrho)
        rows = [myrho, zero, zero, zero, myE, myrho]
        rows += [sub[i] for i in range(len(rows), U.shape[0])]
        Ureset = jnp.stack(rows)
        U = U.at[(slice(None),) + bbox].set(
            jnp.where(inside[None], Ureset, sub))
        return state.replace(U=U)
