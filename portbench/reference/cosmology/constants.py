"""Physical constants shared across fastbox_tpu_torch (a copy of
fastbox_tpu/constants.py).

Values match the conventions of the reference FastBox implementation
(fastbox/box.py:15, foregrounds.py:21-24, forecast.py:4-6).
"""

# Speed of light
C_MS = 299792458.0          # m/s      (reference box.py:15)
C_KMS = 299792.458          # km/s     (reference forecast.py:4)

# 21cm line rest frequency, MHz (reference box.py:26, forecast.py:5)
LINE_FREQ_21CM = 1420.405752
NU21CM = 1420.405751        # forecast.py uses a slightly different constant

# Thermodynamics (reference foregrounds.py:21-24)
KBOLTZ = 1.3806488e-23      # J/K
H_PLANCK = 6.626e-34        # J s
CMB_TEMP = 2.73             # K (Rayleigh-Jeans correction reference value)

# Background radiation (used in the cosmology background model)
T_CMB = 2.725               # K
NEFF = 3.046                # effective number of massless neutrino species

# Effectively-infinite noise used in Fisher forecasts (reference forecast.py:6)
INF_NOISE = 1e50
