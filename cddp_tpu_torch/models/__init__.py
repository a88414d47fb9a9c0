from cddp_tpu_torch.models.acrobot import Acrobot
from cddp_tpu_torch.models.attitude import (EulerAttitude, MrpAttitude, QuaternionAttitude,
                                            euler_attitude, mrp_attitude, quaternion_attitude)
from cddp_tpu_torch.models.base import DynamicalSystem, rollout
from cddp_tpu_torch.models.bicycle import Bicycle
from cddp_tpu_torch.models.car import Car
from cddp_tpu_torch.models.cartpole import CartPole
from cddp_tpu_torch.models.dreyfus_rocket import DreyfusRocket
from cddp_tpu_torch.models.dubins_car import DubinsCar
from cddp_tpu_torch.models.forklift import Forklift
from cddp_tpu_torch.models.lti_system import LTISystem, lti_system
from cddp_tpu_torch.models.pendulum import Pendulum
from cddp_tpu_torch.models.quadrotor import Quadrotor, quadrotor
from cddp_tpu_torch.models.quadrotor_rate import QuadrotorRate
from cddp_tpu_torch.models.spacecraft import (HCW, SpacecraftLanding2D, SpacecraftLinearFuel,
                                              SpacecraftNonlinear, SpacecraftTwobody)
from cddp_tpu_torch.models.unicycle import Unicycle

__all__ = ["Acrobot", "Bicycle", "Car", "CartPole", "DreyfusRocket", "DubinsCar",
           "DynamicalSystem", "EulerAttitude", "Forklift", "HCW", "LTISystem", "MrpAttitude", "Pendulum", "Quadrotor", "QuadrotorRate", "QuaternionAttitude",
           "SpacecraftLanding2D", "SpacecraftLinearFuel", "SpacecraftNonlinear",
           "SpacecraftTwobody", "Unicycle", "euler_attitude", "lti_system", "mrp_attitude",
           "quadrotor", "quaternion_attitude", "rollout"]
