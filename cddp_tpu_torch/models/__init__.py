from cddp_tpu_torch.models.base import DynamicalSystem, rollout
from cddp_tpu_torch.models.cartpole import CartPole
from cddp_tpu_torch.models.pendulum import Pendulum
from cddp_tpu_torch.models.spacecraft import HCW
from cddp_tpu_torch.models.unicycle import Unicycle

__all__ = ["CartPole", "DynamicalSystem", "HCW", "Pendulum", "Unicycle", "rollout"]
