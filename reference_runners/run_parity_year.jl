# Reference-side runner for the 1-simulated-year parity target (BASELINE.md:
# "allclose prognostic fields vs reference after 1 simulated year").
#
# Runs Terrarium.jl under EXACTLY the year-protocol configuration that
# `parity_vs_reference.py --year` / `experiments/run_year.py` use on the JAX
# side (mirroring `test/benchmarks/gpu/soil_heat_hydrology_global.jl:39-51`
# and `examples/simulations/soil_heat_global.jl:29-38`):
#
#   * ERA5-land N145 land-sea mask (>0.5), masked ColumnRingGrid
#   * Float32, ExponentialSpacing(N = 30)
#   * SoilModel: SoilEnergyBalance + SoilHydrology(RichardsEq()),
#     SoilInitializer defaults (QuasiThermalSteadyState T + water table)
#   * annual-cycle surface temperature BC  T_ub(t) = 30 sin(2pi t / year) degC
#   * dt = 60 s, 525,600 steps = 365 days
#
# and writes the final prognostic fields as NetCDF in the layout the parity
# harness consumes:  (z, cell) packed land-cell arrays, z bottom-up
# (Oceananigans' z axis as constructed by ColumnRingGrid increases upward,
# k = 1 deepest). Compare with:
#
#   python parity_vs_reference.py parity_year_n145.nc \
#       --mask /root/reference/inputs/era5-land_land_sea_mask_N145.nc \
#       --period-days 365 --z-order bottom-up
#
# NOTE: Julia is not installed in the build environment, so this script is
# committed UNTESTED; it follows the public API of the reference at the
# pinned snapshot. Run it from the reference repository root:
#
#   julia --project -e 'include("run_parity_year.jl")' \
#       [-- --device gpu] [--days 365] [--out parity_year_n145.nc]

using Terrarium
using NCDatasets
using Rasters
using Dates
import RingGrids

# ---- arguments -------------------------------------------------------------
device = "gpu" in ARGS ? "gpu" : "cpu"
days = let i = findfirst(==("--days"), ARGS)
    i === nothing ? 365 : parse(Int, ARGS[i + 1])
end
out_path = let i = findfirst(==("--out"), ARGS)
    i === nothing ? "parity_year_n145.nc" : ARGS[i + 1]
end
mask_path = let i = findfirst(==("--mask"), ARGS)
    i === nothing ? joinpath(@__DIR__, "..", "inputs",
                             "era5-land_land_sea_mask_N145.nc") : ARGS[i + 1]
end

arch = device == "gpu" ? GPU() : CPU()
NF = Float32

# ---- grid: masked N145 ring grid (soil_heat_global.jl:29-38) ---------------
land_sea_frac = convert.(NF, dropdims(Raster(mask_path), dims = Ti))
land_sea_field = RingGrids.FullGaussianGrid(Matrix(land_sea_frac),
                                            input_as = Matrix)
land_mask = land_sea_field .> 0.5
grid = ColumnRingGrid(arch, NF, ExponentialSpacing(N = 30),
                      land_mask.grid, land_mask)
@info "Masked N145 grid" n_land = sum(land_mask)

# ---- model: the year-protocol configuration --------------------------------
# (soil_heat_hydrology_global.jl:39-51 -- SoilInitializer defaults, default
#  hydraulics, annual-cycle Dirichlet surface temperature)
initializer = SoilInitializer(eltype(grid))
energy = SoilEnergyBalance(NF)
hydrology = SoilHydrology(NF, RichardsEq())
T_ub = PrescribedTemperature((x, t) -> 30 * sin(2π * t / (24 * 3600 * 365)))
boundary_conditions = SoilBoundaryConditions(eltype(grid), energy, hydrology,
                                             top = T_ub)
model = SoilModel(grid; initializer, boundary_conditions, energy, hydrology)
integrator = initialize(model)

# ---- run 1 simulated year at dt = 60 s ------------------------------------
t0 = time()
for month in 1:12
    chunk_days = month < 12 ? days ÷ 12 : days - 11 * (days ÷ 12)
    run!(integrator, period = Day(chunk_days), Δt = 60.0)
    @info "progress" month wall_s = round(time() - t0, digits = 1)
end
@info "year complete" wall_s = round(time() - t0, digits = 1)

# ---- write the harness layout ---------------------------------------------
# interior(...) gives (Nh, 1, Nz); permute to (Nz, Nh), k = 1 deepest
to_zcell(f) = permutedims(dropdims(Array(interior(f)), dims = 2), (2, 1))
T = to_zcell(integrator.state.temperature)
sat = to_zcell(integrator.state.saturation_water_ice)
U = to_zcell(integrator.state.internal_energy)
excess = vec(Array(interior(integrator.state.surface_excess_water)))

NCDataset(out_path, "c") do ds
    defDim(ds, "z", size(T, 1))
    defDim(ds, "cell", size(T, 2))
    for (name, arr) in (("temperature", T), ("saturation_water_ice", sat),
                        ("internal_energy", U))
        v = defVar(ds, name, Float32, ("z", "cell"))
        v[:, :] = arr
    end
    v = defVar(ds, "surface_excess_water", Float32, ("cell",))
    v[:] = excess
    ds.attrib["protocol"] = "terrarium parity year: N145 mask, Nz=30 " *
        "ExponentialSpacing, f32, dt=60, T_ub=30sin(2pi t/yr), $(days) days"
    ds.attrib["z_order"] = "bottom-up"
end
@info "wrote $out_path"
