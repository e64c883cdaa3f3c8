from wgsparkl_tpu_torch.models.elasticity import (
    ElasticCoefficients,
    kirchoff_stress_corotated,
    kirchoff_stress_neo_hookean,
)
from wgsparkl_tpu_torch.models.drucker_prager import (
    DruckerPrager,
    DruckerPragerState,
    drucker_prager_project,
)

__all__ = [
    "ElasticCoefficients",
    "kirchoff_stress_corotated",
    "kirchoff_stress_neo_hookean",
    "DruckerPrager",
    "DruckerPragerState",
    "drucker_prager_project",
]
