from goldfish_jax.operations.disp_imop import DispImOperation
from goldfish_jax.operations.exops import (
    ComplianceExOperation,
    IntEnergyExOperation,
    MaxvMStressExOperation,
    VolumeExOperation,
)

__all__ = [
    "DispImOperation",
    "IntEnergyExOperation",
    "VolumeExOperation",
    "ComplianceExOperation",
    "MaxvMStressExOperation",
]
