"""Umbrella import for CSDL-alpha drivers — mirrors the reference's
GOLDFISH/nonmatching_opt_csdl.py:1-25 (which activates hth_map,
disp_states, int_energy and volume; this build exports the full set).

Requires the optional `csdl_alpha` dependency.
"""

from goldfish_jax.csdl_models.models import (  # noqa: F401
    ComplianceModel,
    CPFE2IGAModel,
    CPFFD2SurfModel,
    CPFFDAlignModel,
    CPFFDPinModel,
    CPFFDReguModel,
    CPIGA2XiModel,
    DispMintStatesModel,
    DispStatesModel,
    HthFE2IGAModel,
    HthFFD2FEModel,
    HthFFDAlignModel,
    HthFFDReguModel,
    HthMapModel,
    IntEnergyModel,
    LinearMapModel,
    MaxvMStressModel,
    VMStressModel,
    VolumeModel,
)
from goldfish_jax.solver.system import NonMatchingSystem  # noqa: F401
