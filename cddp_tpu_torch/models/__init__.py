from cddp_tpu_torch.models.base import DynamicalSystem, rollout
from cddp_tpu_torch.models.car import Car
from cddp_tpu_torch.models.cartpole import CartPole
from cddp_tpu_torch.models.forklift import Forklift
from cddp_tpu_torch.models.lti_system import LTISystem, lti_system
from cddp_tpu_torch.models.pendulum import Pendulum
from cddp_tpu_torch.models.spacecraft import HCW
from cddp_tpu_torch.models.unicycle import Unicycle

__all__ = ["Car", "CartPole", "DynamicalSystem", "Forklift", "HCW", "LTISystem", "Pendulum",
           "Unicycle", "lti_system", "rollout"]
