"""terrarium_tpu — a JAX land-surface modeling framework.

A from-scratch JAX/XLA implementation with the capabilities of the
reference Julia framework (Terrarium.jl): laterally-independent vertical soil
columns with two-phase heat conduction, Richards-equation hydrology, surface
energy balance, surface hydrology, and PALADYN vegetation carbon dynamics,
over column batches or masked global ring grids.

Design (accelerator-first, not a port):

* fields are ``(Nz, cells)`` arrays — cells on the trailing (contiguous)
  axis, sharded across devices via `jax.sharding`; z stays local to each
  device;
* the whole model step is one pure jitted function; rollouts are `lax.scan`s;
* differentiability via `jax.grad` + `jax.checkpoint` (replacing Enzyme);
* explicit *and* implicit (batched tridiagonal) timesteppers.
"""

__version__ = "0.1.0"

from .constants import PhysicalConstants
from .variables import (XY, XYZ, Variable, Variables, auxiliary, input,
                        namespace, prognostic)
from .state import Clock, State, build_state
from .grids import (ColumnGrid, ColumnRingGrid, ExponentialSpacing,
                    PrescribedSpacing, RingGrid, UniformSpacing, VerticalGrid,
                    full_gaussian_grid, full_healpix_grid)
from .ops.bcs import Dirichlet, Flux, Neumann, NoFlux, merge_boundary_conditions
from .processes.base import Context, Process
from .processes.soil import (
    BrooksCorey,
    ConstantSoilCarbonDensity,
    ConstantSoilHydraulics,
    ConstantSoilPorosity,
    FreeWater,
    HomogeneousStratigraphy,
    InverseQuadratic,
    NoFlow,
    RichardsEq,
    SoilEnergyBalance,
    SoilEnergyTemperatureClosure,
    SoilEnergyWaterCarbon,
    SoilHeatCapacities,
    SoilHydraulicsSURFEX,
    SoilHydrology,
    SoilPorositySURFEX,
    SoilSaturationPressureClosure,
    SoilTexture,
    SoilThermalConductivities,
    SoilThermalProperties,
    SoilVolume,
    UnsatKLinear,
    UnsatKVanGenuchten,
    VanGenuchten,
    volumetric_fractions,
)
from .models import (
    ConstantSaturation,
    ConstantSoilTemperature,
    DefaultInitializer,
    FreeDrainage,
    GeothermalHeatFlux,
    GroundHeatFlux,
    ImpermeableBoundary,
    InfiltrationFlux,
    PiecewiseLinearInitialSoilTemperature,
    PrescribedBottomTemperature,
    PrescribedSurfaceTemperature,
    QuasiThermalSteadyState,
    SaturationWaterTable,
    SoilInitializer,
    SoilModel,
)
from .processes.atmosphere import (AmbientCO2, ConstantAerodynamics,
                                   LongShortWaveRadiation,
                                   MoninObukhovAerodynamics,
                                   PrescribedAtmosphere, RainSnow,
                                   SpecificHumidity, TracerGas)
from .processes.surface_energy import (ConstantAlbedo, DiagnosedRadiativeFluxes,
                                       DiagnosedTurbulentFluxes,
                                       ImplicitSkinTemperature, PrescribedAlbedo,
                                       PrescribedRadiativeFluxes,
                                       PrescribedSkinTemperature,
                                       PrescribedTurbulentFluxes,
                                       SurfaceEnergyBalance)
from .processes.snow import SnowCoverAlbedo, Snowpack
from .processes.surface_hydrology import (BareGroundEvaporation,
                                          ConstantEvaporationResistanceFactor,
                                          DirectSurfaceRunoff,
                                          NoCanopyInterception,
                                          PALADYNCanopyEvapotranspiration,
                                          PALADYNCanopyInterception,
                                          SoilMoistureResistanceFactor,
                                          SurfaceHydrology)
from .processes.vegetation import (FieldCapacityLimitedPAW,
                                   LUEPhotosynthesis,
                                   MedlynStomatalConductance,
                                   PALADYNAutotrophicRespiration,
                                   PALADYNCarbonDynamics, PALADYNPhenology,
                                   PALADYNVegetationDynamics,
                                   StaticExponentialRootDistribution,
                                   VegetationCarbon)
from .models.land_model import LandModel
from .models.vegetation_model import SurfaceEnergyModel, VegetationModel
from .timesteppers import ForwardEuler, Heun, ImplicitEuler, Simulation, initialize
from .io.input_sources import FieldInputSource, TimeSeriesInputSource
from .io.netcdf import load_land_mask, read_netcdf, write_netcdf
from .io.raster import RasterInputSource, raster_input_source
from .io.output import (AveragedTimeInterval, FieldTimeSeriesWriter,
                        NetCDFRasterWriter, IterationInterval, ProgressLogger, TimeInterval,
                        load_field_time_series)
from .io.checkpoint import load_checkpoint, save_checkpoint
from .io.forcing_pipeline import ChunkedForcingPipeline
from .parallel.halo import (lateral_diffusion_forcing,
                            lateral_diffusion_forcing_ring,
                            neighbor_shift)
from .parallel.sharding import (cell_mesh, initialize_distributed,
                                shard_sources, shard_state)
from .diagnostics.budget import BudgetTracker, ExactBudget, energy_column, energy_rates, water_column, water_rates
from .diagnostics.debug import debug_callback, enable_debug, nancheck
from .diagnostics.profiling import compile_seconds, profile_rollout, step_timings
