"""Umbrella import for OpenMDAO drivers — mirrors the reference's
GOLDFISH/nonmatching_opt_om.py:1-36 (including providing the
CPFFDAlignComp its tree is missing; SURVEY.md section 2.3).

Requires the optional `openmdao` dependency.
"""

from goldfish_jax.om_comps.components import (  # noqa: F401
    ComplianceComp,
    CPFE2IGAComp,
    CPFFD2SurfComp,
    CPFFDAlignComp,
    CPFFDPinComp,
    CPFFDReguComp,
    CPFFDReguCompAgg,
    CPIGA2XiComp,
    CPSurfAlignComp,
    CPSurfDistanceComp,
    CPSurfKnotRefienmentComp,
    CPSurfOrderElevationComp,
    CPSurfPinComp,
    CPSurfReguComp,
    DispMintStatesComp,
    DispStatesComp,
    HthFE2IGAComp,
    HthFFD2FEComp,
    HthFFDAlignComp,
    HthFFDReguComp,
    HthMapComp,
    IntEnergyComp,
    IntEnergyReguComp,
    IntXiEdgeComp,
    MaxIntXiComp,
    MaxvMStressComp,
    MinIntXiComp,
    VMStressComp,
    VolumeComp,
)
from goldfish_jax.solver.system import NonMatchingSystem  # noqa: F401
