"""atmospheric_athena_tpu — a JAX framework with the capabilities of
tripathi/Atmospheric-Athena: finite-volume (M)HD on structured grids with
plane-parallel ionizing radiative transfer, written as whole-grid array
programs (SPMD over device meshes, functional transforms) rather than
translated from the reference's C/MPI design.
"""

from .config import GridConfig, SimConfig
from .par import ParameterDB
from .simulation import Simulation
from .state import State

__version__ = "0.1.0"
__all__ = ["GridConfig", "SimConfig", "ParameterDB", "Simulation", "State"]
