"""Physical constants (reference: radiation/radiation_constants.F90,
ifsaux/yomcst_ecrad.F90, radiation/radiation_gas_constants.F90:42-57)."""

# Fundamental
PI = 3.14159265358979323846
STEFAN_BOLTZMANN = 5.670374419e-8      # W m-2 K-4
ACCEL_GRAVITY = 9.80665                # m s-2 (yomcst RG)
R_DRY = 287.058                        # J kg-1 K-1
SPECIFIC_HEAT_AIR = 1004.709           # J kg-1 K-1 (cp, dry air)

# Planck / spectral
PLANCK = 6.62607015e-34                # J s
BOLTZMANN = 1.380649e-23               # J K-1
SPEED_OF_LIGHT = 2.99792458e8          # m s-1
AVOGADRO = 6.02214076e23               # mol-1

# Molar masses, g mol-1 (radiation_gas_constants.F90:42-57)
MOLAR_MASS_DRY_AIR = 28.970
MOLAR_MASS = {
    "h2o": 18.0152833,
    "co2": 44.011,
    "o3": 47.9982,
    "n2o": 44.013,
    "co": 28.0101,
    "ch4": 16.043,
    "o2": 31.9988,
    "cfc11": 137.3686,
    "cfc12": 120.914,
    "hcfc22": 86.469,
    "ccl4": 153.823,
    "no2": 46.0055,
}

# Gas indices (radiation_gas_constants.F90:26-39). Index 0 unused in the
# reference ("IGasNotPresent"); here gases are 0-based in a fixed order.
GAS_NAMES = (
    "h2o", "co2", "o3", "n2o", "co", "ch4", "o2",
    "cfc11", "cfc12", "hcfc22", "ccl4", "no2",
)
NUM_GASES = len(GAS_NAMES)
GAS_INDEX = {name: i for i, name in enumerate(GAS_NAMES)}

# Diffusivity factor for longwave flux from radiance
# (radiation_two_stream.F90:38-39)
LW_DIFFUSIVITY = 1.66
# Minimum cos(solar zenith angle) guard used when dividing by mu0
MIN_MU0 = 1.0e-6
