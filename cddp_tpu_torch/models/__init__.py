from cddp_tpu_torch.models.attitude import (EulerAttitude, MrpAttitude, QuaternionAttitude,
                                            euler_attitude, mrp_attitude, quaternion_attitude)
from cddp_tpu_torch.models.base import DynamicalSystem, rollout
from cddp_tpu_torch.models.car import Car
from cddp_tpu_torch.models.cartpole import CartPole
from cddp_tpu_torch.models.forklift import Forklift
from cddp_tpu_torch.models.lti_system import LTISystem, lti_system
from cddp_tpu_torch.models.pendulum import Pendulum
from cddp_tpu_torch.models.quadrotor import Quadrotor, quadrotor
from cddp_tpu_torch.models.quadrotor_rate import QuadrotorRate
from cddp_tpu_torch.models.spacecraft import HCW
from cddp_tpu_torch.models.unicycle import Unicycle

__all__ = ["Car", "CartPole", "DynamicalSystem", "EulerAttitude", "Forklift", "HCW", "LTISystem",
           "MrpAttitude", "Pendulum", "Quadrotor", "QuadrotorRate", "QuaternionAttitude",
           "Unicycle", "euler_attitude", "lti_system", "mrp_attitude", "quadrotor",
           "quaternion_attitude", "rollout"]
