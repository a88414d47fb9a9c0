from cddp_tpu_torch.models.base import DynamicalSystem, rollout
from cddp_tpu_torch.models.unicycle import Unicycle

__all__ = ["DynamicalSystem", "Unicycle", "rollout"]
